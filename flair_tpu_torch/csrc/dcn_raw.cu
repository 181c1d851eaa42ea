// Flow-anchored modulated deformable conv (DCNv2) with the raw offset prep
// fused in, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// flair_tpu_torch/ops/dcn.py.
//
// Replaces: flair_tpu/ops/dcn_pallas.py::_dcn_tile_kernel (launched by
// deform_conv2d_tile / deform_conv2d_tile_raw_ad, reached from
// flair_tpu/models/vsrpp.py apply_deform_align).
//
// What it computes, per output pixel p of x (B, H, W, Cin) NHWC:
//   off[p,g,k] = mrm * tanh(res[p, g*9+k]) + flow[p, g / (G/A)]   (y and x)
//   m[p,g,k]   = sigmoid(mask_logits[p, g*9+k])
//   out[p,:]   = bias + sum_{k,c} W[k,c,:] * m[p,g(c),k]
//                 * bilinear(x[:,:,:,c], p + tap_k + off[p,g(c),k])
// with 3x3 taps, dilation 1, one conv group, G deform groups over Cin
// (channel c belongs to group c / (Cin/G)), the first G/A groups anchored on
// flow 0 and so on. Bilinear sampling is EXACT: a corner outside the image
// contributes zero, each corner tested on its own. (The TPU kernel zeroes a
// whole sample whose support leaves its tile's patch; that is a TPU layout
// workaround and is not copied.)
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s): one call does
// 2*H*W*9*Cin*Cout FLOP = 3.87e10 at both main-path shapes (512^2, Cin 128,
// Cout 64 and 256^2, Cin 256, Cout 128). The bytes it must move (x, the three
// (H,W,G*9=144) raw blocks, both flow planes, the output; bf16) are 331 MB at
// 512^2 and 108 MB at 256^2. Bound: max(bytes/3.35e12, FLOP/989e12) =
// 0.099 ms (bytes) at 512^2 and 0.039 ms (operations) at 256^2.
//
// The simple design: one block owns TP=64 consecutive output pixels and all
// Cout. It walks K = 9 taps x Cin in chunks of CK=32 channels. For each chunk
// it samples the 64 x 32 modulated values into shared memory (each thread one
// 16-byte vector of channels: four 16-byte corner loads, which hit L1/L2
// because flows are smooth and neighbouring pixels sample neighbouring
// rows), stages the matching 32 x Cout slice of W, and contracts: bf16 on the
// tensor cores through WMMA 16x16x16 with f32 accumulators in registers, f32
// inputs with CUDA-core FMAs (the exact path the CPU-parity runs use). The
// raw blocks are read once per (pixel, group, tap) and never materialized as
// offsets; x is read from L2 about 4x per tap. No double buffering and no
// TMA/wgmma yet: a sync separates sampling from the contraction, so the
// kernel is latency-bound, not at the bound above.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;         // output pixels per block
constexpr int CK = 32;         // input channels per K step
constexpr int NTHREADS = 256;  // 8 warps

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16-byte vector <-> floats
__device__ __forceinline__ void unpack(const uint4& u, float* v, float) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* v, __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

__device__ __forceinline__ float store_cast(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 store_cast(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <typename T, int COUT>
__global__ void __launch_bounds__(NTHREADS)
dcn_raw_kernel(const T* __restrict__ x, const T* __restrict__ res_y,
               const T* __restrict__ res_x, const T* __restrict__ mlog,
               const float* __restrict__ flow_y,
               const float* __restrict__ flow_x, const T* __restrict__ wk,
               const float* __restrict__ bias, T* __restrict__ out, int npix,
               int H, int W, int cin, int G, int A, long long raw_stride,
               float mrm) {
  using namespace nvcuda;
  constexpr bool kBF16 = sizeof(T) == 2;
  constexpr int VEC = 16 / sizeof(T);  // channels per 16-byte vector
  constexpr int NO = CK / VEC;         // vectors per pixel per K step
  constexpr int ITEMS = TP * NO;
  constexpr int AS_LD = kBF16 ? CK + 8 : CK + 1;  // As row stride (elements)
  constexpr int BS_LD = kBF16 ? COUT + 8 : COUT;  // Bs row stride (elements)
  constexpr int CS_LD = COUT + 4;                 // f32 epilogue stride
  constexpr int AS_BYTES = ((TP * AS_LD * (int)sizeof(T)) + 127) / 128 * 128;
  constexpr int AB_BYTES = AS_BYTES + CK * BS_LD * (int)sizeof(T);
  constexpr int C_BYTES = kBF16 ? TP * CS_LD * 4 : 0;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  constexpr int NF = COUT / 32;  // 16-wide column fragments per warp (bf16)
  constexpr int CPT = COUT / 4;  // output columns per thread (f32)

  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + AS_BYTES);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int cg = cin / G;
  const int ga = G / A;
  const int nchunk = cin / CK;
  const long long hw = (long long)H * W;

  const int warp = tid / 32;
  const int rb = warp % 4;               // 16-row block of the 64 pixels
  const int cb0 = (warp / 4) * NF;       // first 16-col block of this warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  float facc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) facc[j] = 0.0f;

  for (int k = 0; k < 9; ++k) {
    const int dy = k / 3 - 1, dx = k % 3 - 1;
    for (int cc = 0; cc < nchunk; ++cc) {
      __syncthreads();  // the previous step's contraction is done with As/Bs
      // ---- sample 64 pixels x CK channels into As -------------------------
      for (int it = tid; it < ITEMS; it += NTHREADS) {
        const int o = it % NO, p = it / NO;
        const int pix = p0 + p;
        const int c0 = cc * CK + o * VEC;
        float v[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = 0.0f;
        if (pix < npix) {
          const int g = c0 / cg;
          const int a = g / ga;
          const long long rbase = (long long)pix * raw_stride + g * 9 + k;
          const float oy = mrm * tanhf(to_f(res_y[rbase])) +
                           flow_y[(long long)pix * A + a];
          const float ox = mrm * tanhf(to_f(res_x[rbase])) +
                           flow_x[(long long)pix * A + a];
          const float m = 1.0f / (1.0f + expf(-to_f(mlog[rbase])));
          const int xq = pix % W;
          const int yq = (pix / W) % H;
          const long long b = pix / hw;
          const float sy = (float)(yq + dy) + oy;
          const float sx = (float)(xq + dx) + ox;
          const float y0 = floorf(sy), x0 = floorf(sx);
          const float ly = sy - y0, lx = sx - x0;
          const bool vy0 = y0 >= 0.0f && y0 <= (float)(H - 1);
          const bool vy1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1);
          const bool vx0 = x0 >= 0.0f && x0 <= (float)(W - 1);
          const bool vx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1);
          const T* xb = x + b * hw * cin + c0;
          float cv[VEC];
          // corners in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1)
#define DCN_CORNER(VY, VX, YY, XX, WT)                                     \
  if ((VY) && (VX)) {                                                      \
    const uint4 u = *reinterpret_cast<const uint4*>(                       \
        xb + ((long long)(YY) * W + (XX)) * cin);                          \
    unpack(u, cv, T());                                                    \
    const float wt = (WT);                                                 \
    _Pragma("unroll") for (int i = 0; i < VEC; ++i) v[i] += cv[i] * wt;    \
  }
          const int iy0 = vy0 ? (int)y0 : 0, iy1 = vy1 ? (int)y0 + 1 : 0;
          const int ix0 = vx0 ? (int)x0 : 0, ix1 = vx1 ? (int)x0 + 1 : 0;
          DCN_CORNER(vy0, vx0, iy0, ix0, (1.0f - ly) * (1.0f - lx))
          DCN_CORNER(vy0, vx1, iy0, ix1, (1.0f - ly) * lx)
          DCN_CORNER(vy1, vx0, iy1, ix0, ly * (1.0f - lx))
          DCN_CORNER(vy1, vx1, iy1, ix1, ly * lx)
#undef DCN_CORNER
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] *= m;
        }
        if constexpr (kBF16) {
          *reinterpret_cast<uint4*>(As + p * AS_LD + o * VEC) = pack(v, T());
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) As[p * AS_LD + o * VEC + i] = v[i];
        }
      }
      // ---- stage W[k, cc*CK : cc*CK+CK, :] into Bs --------------------------
      for (int it = tid; it < CK * COUT / VEC; it += NTHREADS) {
        const int row = it / (COUT / VEC);
        const int col = (it % (COUT / VEC)) * VEC;
        *reinterpret_cast<uint4*>(Bs + row * BS_LD + col) =
            *reinterpret_cast<const uint4*>(
                wk + ((long long)k * cin + cc * CK + row) * COUT + col);
      }
      __syncthreads();
      // ---- contract the chunk ---------------------------------------------
      if constexpr (kBF16) {
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::load_matrix_sync(
              fa, reinterpret_cast<const __nv_bfloat16*>(As) +
                      rb * 16 * AS_LD + kk * 16, AS_LD);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(
                fb, reinterpret_cast<const __nv_bfloat16*>(Bs) +
                        kk * 16 * BS_LD + (cb0 + j) * 16, BS_LD);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      } else {
        const int p = tid & (TP - 1), s = tid / TP;
#pragma unroll 4
        for (int kc = 0; kc < CK; ++kc) {
          const float av = to_f(As[p * AS_LD + kc]);
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            facc[j] += av * to_f(Bs[kc * BS_LD + s * CPT + j]);
        }
      }
    }
  }

  // ---- epilogue: + bias, round to T, NHWC store -----------------------------
  if constexpr (kBF16) {
    __syncthreads();  // Cs aliases As/Bs
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(Cs + rb * 16 * CS_LD + (cb0 + j) * 16, acc[j],
                              CS_LD, wmma::mem_row_major);
    __syncthreads();
    for (int it = tid; it < TP * COUT; it += NTHREADS) {
      const int p = it / COUT, c = it % COUT;
      const int pix = p0 + p;
      if (pix < npix)
        out[(long long)pix * COUT + c] =
            store_cast(Cs[p * CS_LD + c] + bias[c], T());
    }
  } else {
    const int p = tid & (TP - 1), s = tid / TP;
    const int pix = p0 + p;
    if (pix < npix) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[(long long)pix * COUT + s * CPT + j] =
            store_cast(facc[j] + bias[s * CPT + j], T());
    }
  }
}

template <typename T, int COUT>
void launch(const void* x, const void* ry, const void* rx, const void* ml,
            const void* fy, const void* fx, const void* wk, const void* bias,
            void* out, int npix, int H, int W, int cin, int G, int A,
            long long raw_stride, float mrm, cudaStream_t stream) {
  const dim3 grid((npix + TP - 1) / TP);
  dcn_raw_kernel<T, COUT><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ry),
      static_cast<const T*>(rx), static_cast<const T*>(ml),
      static_cast<const float*>(fy), static_cast<const float*>(fx),
      static_cast<const T*>(wk), static_cast<const float*>(bias),
      static_cast<T*>(out), npix, H, W, cin, G, A, raw_stride, mrm);
}

template <typename T>
int dispatch(int cout, const void* x, const void* ry, const void* rx,
             const void* ml, const void* fy, const void* fx, const void* wk,
             const void* bias, void* out, int npix, int H, int W, int cin,
             int G, int A, long long raw_stride, float mrm,
             cudaStream_t stream) {
  switch (cout) {
    case 32:
      launch<T, 32>(x, ry, rx, ml, fy, fx, wk, bias, out, npix, H, W, cin, G,
                    A, raw_stride, mrm, stream);
      break;
    case 64:
      launch<T, 64>(x, ry, rx, ml, fy, fx, wk, bias, out, npix, H, W, cin, G,
                    A, raw_stride, mrm, stream);
      break;
    case 128:
      launch<T, 128>(x, ry, rx, ml, fy, fx, wk, bias, out, npix, H, W, cin,
                     G, A, raw_stride, mrm, stream);
      break;
    default:
      return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches one DCN on `stream` and returns cudaGetLastError() (0 = launched),
// or -1 for a Cout the kernel is not instantiated for. is_bf16 selects the
// element type of x / res_y / res_x / mask_logits / wk / out (else float32);
// flows and bias are always float32. wk is (9, Cin, Cout), tap-major.
int dcn_raw_forward(int is_bf16, const void* x, const void* res_y,
                    const void* res_x, const void* mask_logits,
                    const void* flow_y, const void* flow_x, const void* wk,
                    const void* bias, void* out, int npix, int H, int W,
                    int cin, int cout, int G, int A, long long raw_stride,
                    float mrm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      is_bf16
          ? dispatch<__nv_bfloat16>(cout, x, res_y, res_x, mask_logits,
                                    flow_y, flow_x, wk, bias, out, npix, H, W,
                                    cin, G, A, raw_stride, mrm, s)
          : dispatch<float>(cout, x, res_y, res_x, mask_logits, flow_y,
                            flow_x, wk, bias, out, npix, H, W, cin, G, A,
                            raw_stride, mrm, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* dcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
