// Flash-attention forward for Hopper (sm_90a): softmax(q k^T * scale) v over
// (B, S, H, D) heads, with the online softmax in float32. Plain C interface,
// loaded with ctypes by flair_tpu_torch/ops/attention.py::flash_attention.
//
// Replaces: flair_tpu/ops/attention.py::_flash_kernel (launched by
// _flash_attention_bhsd <- flash_attention, reached from the BlurUNet's
// AttentionBlock / AttentionBottleBlock, flair_tpu/models/blocks.py).
//
// Layout. q, k and v are read as strided views of the packed qkv Dense
// output: element (b, s, h, d) of each lies at ptr + b*sb + s*ss + h*sh + d,
// the three sharing (sb, ss, sh). For the per-head interleave
// qkv.reshape(N, S, heads, 3, D) that is ss = 3*heads*D, sh = 3*D and the
// k / v pointers D and 2*D past q: no transposes and no copies. The output is
// written (B, S, H, D) contiguous, which the projection takes as (B, S, H*D).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s), bf16, D = 64,
// at the BlurUNet's three serving shapes (10-frame window, B = 1):
//   S = 1024, BH = 40: 4*BH*S*S*D = 1.07e10 FLOP -> 0.011 ms; q, k, v, o
//     are 21 MB -> 0.006 ms: bound by operations.
//   S = 256, BH = 80: 2.7e9 FLOP -> 0.0027 ms; 10.5 MB -> 0.0031 ms:
//     bound by bytes (and, at a few microseconds, by launch latency).
//   S = 64, BH = 80: bound by bytes (2.6 MB, 0.0008 ms) and launch latency.
//
// The simple design (FlashAttention-2 style). A block of 4 warps owns one
// (batch*head, 64-query tile); each warp owns 16 query rows and keeps its
// Q fragments, its f32 output accumulator and its row max / sum in
// registers. The block loops over 64-key tiles staged in shared memory
// (V stored transposed so the P*V operand is a 32-bit load). Both
// contractions run on the tensor cores with mma.sync m16n8k16 bf16 -> f32;
// the S = Q K^T accumulator layout is reused in registers as the A operand
// of P V, so P never leaves registers. Keys past S in the last tile are
// masked to -inf, queries past S are not stored, so any S works. Work per
// block is the 2*64*S*D FLOP of its tile against 2*S*D bytes of K/V reads,
// so at S = 1024 the kernel is meant to be compute-limited; at S = 256 and
// 64 the grid is 80-320 blocks of short loops, latency-limited. There is no
// cp.async / TMA double buffering and no wgmma yet: loads and MMAs do not
// overlap, which is the next step for a later change.
//
// A float32 instance (CUDA-core FMAs, one thread per query row, the online
// softmax per key) serves the f32 parity runs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int NWARPS = BQ / 16;   // one warp per 16 query rows (bf16)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same), a2 (row g, cols
//      2t+8..), a3 (row g+8, cols 2t+8..);
//   B: b0 (rows 2t..2t+1, col g), b1 (rows 2t+8.., col g);
//   C: c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same).
template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int S, int H, long long sb,
               long long ss, long long sh, float scale_log2) {
  constexpr int LD = D + 8;     // Qs / Ks row stride: conflict-free fragments
  constexpr int LDV = BK + 8;   // Vt row stride
  constexpr int VPR = D / 8;    // 16-byte vectors per row
  constexpr int NT = BK / 8;    // 8-key column tiles of S
  constexpr int NO = D / 8;     // 8-wide column tiles of O
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long long base = (long long)b * sb + (long long)h * sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int it = tid; it < BQ * VPR; it += NWARPS * 32) {
    const int r = it / VPR, c = (it % VPR) * 8;
    const uint4 val =
        q0 + r < S ? *reinterpret_cast<const uint4*>(
                         q + base + (long long)(q0 + r) * ss + c)
                   : zero;
    *reinterpret_cast<uint4*>(Qs + r * LD + c) = val;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = Qs + r0 * LD + kk * 16 + t4 * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows g and g+8
  float l0 = 0.0f, l1 = 0.0f;            // this lane's partial row sums

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K / V tile
    for (int it = tid; it < BK * VPR; it += NWARPS * 32) {
      const int r = it / VPR, c = (it % VPR) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S) {
        const long long off = base + (long long)(k0 + r) * ss + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LDV + r] = ve[i];
    }
    __syncthreads();

    // ---- S = Q K^T: this warp's 16 rows x 64 keys ------------------------
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma16816(s[nt], qa[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    }
    // ---- online softmax in log2 units, keys past S masked -----------------
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + nt * 8 + t4 * 2 + (j & 1);
        s[nt][j] = key < S ? s[nt][j] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }
    // ---- O += P V: the S accumulators of two key tiles are one A operand --
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const __nv_bfloat16* vr = Vt + (j * 8 + g) * LDV + ks * 16 + t4 * 2;
        mma16816(o[j], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  // ---- epilogue: divide by the row sums, (B, S, H, D) store ----------------
  const float inv0 = 1.0f / quad_sum(l0), inv1 = 1.0f / quad_sum(l1);
  const int row0 = q0 + r0, row1 = row0 + 8;
  __nv_bfloat16* o0 = out + (((long long)b * S + row0) * H + h) * D + t4 * 2;
  __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(o0 + j * 8) =
          pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(o1 + j * 8) =
          pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// float32: one thread per query row; K / V tiles in shared memory.
template <int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
              int H, long long sb, long long ss, long long sh,
              float scale_log2) {
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row = blockIdx.x * BQ + tid;
  const long long base = (long long)b * sb + (long long)h * sh;

  float qr[D], acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = row < S ? q[base + (long long)row * ss + i] * scale_log2 : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    for (int it = tid; it < BK * D / 4; it += BQ) {
      const int r = it / (D / 4), c = (it % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S) {
        const long long off = base + (long long)(k0 + r) * ss + c;
        kv = *reinterpret_cast<const float4*>(k + off);
        vv = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(Ks + r * D + c) = kv;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vv;
    }
    __syncthreads();
    const int nk = min(BK, S - k0);
    for (int j = 0; j < nk; ++j) {
      float sj = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) sj = fmaf(qr[i], Ks[j * D + i], sj);
      const float mn = fmaxf(m, sj);
      const float al = exp2f(m - mn), p = exp2f(sj - mn);
      l = l * al + p;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = fmaf(p, Vs[j * D + i], acc[i] * al);
      m = mn;
    }
  }
  if (row < S) {
    float* o = out + (((long long)b * S + row) * H + h) * D;
    const float inv = 1.0f / l;
#pragma unroll
    for (int i = 0; i < D; ++i) o[i] = acc[i] * inv;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int S, int H, long long sb, long long ss, long long sh,
            float scale_log2, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  if constexpr (sizeof(T) == 2) {
    flash_fwd_bf16<D><<<grid, NWARPS * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, H, sb, ss, sh,
        scale_log2);
  } else {
    flash_fwd_f32<D><<<grid, BQ, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, H, sb, ss, sh,
        scale_log2);
  }
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, long long sb, long long ss, long long sh,
             float scale_log2, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch<T, 32>(q, k, v, out, B, S, H, sb, ss, sh, scale_log2, stream);
      return 0;
    case 64:
      launch<T, 64>(q, k, v, out, B, S, H, sb, ss, sh, scale_log2, stream);
      return 0;
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// Launches one attention on `stream` and returns cudaGetLastError()
// (0 = launched), or -1 for a head dim the kernel is not instantiated for.
// is_bf16 selects bf16 q / k / v / out (else float32). Strides are in
// elements and shared by q, k and v; out is (B, S, H, D) contiguous.
int flash_attn_forward(int is_bf16, const void* q, const void* k,
                       const void* v, void* out, int B, int S, int H, int D,
                       long long sb, long long ss, long long sh, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  const int rc =
      is_bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, out, B, S, H, sb, ss, sh,
                                        sl2, st)
              : dispatch<float>(D, q, k, v, out, B, S, H, sb, ss, sh, sl2, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
