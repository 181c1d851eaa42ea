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
// 0.099 ms (bytes) at 512^2 and 0.039 ms (operations) at 256^2. What binds
// in practice is below DRAM: the exact bilinear gathers, four 16-byte corner
// loads per (pixel, tap, 8 channels), each from its own line at scattered
// offsets (about 2.4 GB of L1/L2 requests a call at 512^2, 1.2 GB at
// 256^2), behind a dependent chain (raw value -> tanh -> address -> load ->
// blend) that has to finish before each K-step's MMAs.
//
// The bf16 design (dcn_raw_bf16). A block of 8 warps owns an 8 x 16 tile of
// output pixels (BP = 128) and all Cout. It walks the contraction depth in
// K-steps of (32-channel chunk, tap), chunk outer and tap inner, 9 * Cin/32
// steps:
// - Raw offsets and masks are staged per chunk. A chunk's groups cover one
//   contiguous run of 9 * groups values per pixel in each of the three raw
//   blocks (<= 72 bytes); each pixel's run, widened to 16-byte alignment
//   (<= 6 chunks), goes to shared memory with coalesced 16-byte cp.async
//   under the previous chunk's last MMAs. Each raw value leaves DRAM once;
//   a thread reads its pixels' anchor flows once a chunk.
// - Sampling items are (pixel, group, tap) with 8 or 16 channels of the
//   group (16 when Cin/G is a multiple of 16). tanh and sigmoid (in their
//   ex2.approx forms) and the four corner weights, the mask folded in, are
//   computed once per item, i.e. once per (pixel, group, tap) whenever
//   Cin/G <= 16 (both main-path shapes). The four corner loads of one
//   16-byte vector are in flight together and are blended in f32.
// - Pipeline: A (sampled, modulated bf16 values, 128 x 32) and B (the
//   32 x Cout slice of W, staged with cp.async) have two stages each. In
//   K-step s a warp starts the copy of B for step s+1, runs the MMAs of
//   step s, then gathers A of step s+1 (MMAs first measured 3-4 % faster
//   than gathers first); one __syncthreads a K-step (two where a chunk
//   opens).
// - Contraction: mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix.x4 (A) and
//   ldmatrix.x4.trans (B read in its natural (channel, cout) layout). Warps
//   are 4 (pixels) x 2 (Cout): each owns 32 pixels x Cout/2. Rows are padded
//   by 8 bf16, so ldmatrix reads are free of bank conflicts.
// - Epilogue: bias added in f32, rounded to bf16 into a shared tile (over
//   the raw and A stages), written NHWC as 16-byte coalesced stores.
// - 128-pixel blocks read W (147 KB at 512^2, 590 KB at 256^2) from L2 half
//   as often as 64-pixel blocks would. Shared memory is dynamic (65 KB at
//   Cout = 64, 73 KB at 128), so the launch sets
//   cudaFuncAttributeMaxDynamicSharedMemorySize first. 2 blocks (16 warps)
//   an SM, at most 128 registers a thread: a thread holds one vector's four
//   corners at a time, not all of its items', which keeps the 64 f32
//   accumulators of Cout = 128 in registers.
// Measured and not kept: corner loads held across the MMAs (no faster, and
// they spilled), a second raw stage (less L1, slower), a group-planar copy
// of x so that a lane pair reads a sample's two columns from one line (the
// extra pass and the duplicated prep outweighed it), a carveout that left
// more L1 (slower than the default carveout).
//
// A float32 instance (dcn_raw_f32: 64 pixels a block, tap outer, CUDA-core
// FMAs) serves the exact parity runs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---- float32 instance -------------------------------------------------------

constexpr int TP = 64;         // f32: output pixels per block
constexpr int CK = 32;         // input channels per K-step (both instances)
constexpr int NTHREADS = 256;  // 8 warps (both instances)

template <int COUT>
__global__ void __launch_bounds__(NTHREADS)
dcn_raw_f32(const float* __restrict__ x, const float* __restrict__ res_y,
            const float* __restrict__ res_x, const float* __restrict__ mlog,
            const float* __restrict__ flow_y, const float* __restrict__ flow_x,
            const float* __restrict__ wk, const float* __restrict__ bias,
            float* __restrict__ out, int npix, int H, int W, int cin, int G,
            int A, long long raw_stride, float mrm) {
  constexpr int VEC = 4;          // channels per 16-byte vector
  constexpr int NO = CK / VEC;    // vectors per pixel per K-step
  constexpr int ITEMS = TP * NO;
  constexpr int AS_LD = CK + 1;   // As row stride (elements)
  constexpr int CPT = COUT / 4;   // output columns per thread

  __shared__ float As[TP * AS_LD];
  __shared__ __align__(16) float Bs[CK * COUT];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int cg = cin / G;
  const int ga = G / A;
  const int nchunk = cin / CK;
  const long long hw = (long long)H * W;
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
        float v[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (pix < npix) {
          const int g = c0 / cg;
          const int a = g / ga;
          const long long rbase = (long long)pix * raw_stride + g * 9 + k;
          const float oy = mrm * tanhf(res_y[rbase]) +
                           flow_y[(long long)pix * A + a];
          const float ox = mrm * tanhf(res_x[rbase]) +
                           flow_x[(long long)pix * A + a];
          const float m = 1.0f / (1.0f + expf(-mlog[rbase]));
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
          const float* xb = x + b * hw * cin + c0;
          // corners in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1)
#define DCN_CORNER(VY, VX, YY, XX, WT)                                     \
  if ((VY) && (VX)) {                                                      \
    const float4 u = *reinterpret_cast<const float4*>(                     \
        xb + ((long long)(YY) * W + (XX)) * cin);                          \
    const float wt = (WT);                                                 \
    v[0] += u.x * wt; v[1] += u.y * wt; v[2] += u.z * wt; v[3] += u.w * wt; \
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
#pragma unroll
        for (int i = 0; i < VEC; ++i) As[p * AS_LD + o * VEC + i] = v[i];
      }
      // ---- stage W[k, cc*CK : cc*CK+CK, :] into Bs --------------------------
      for (int it = tid; it < CK * COUT / VEC; it += NTHREADS) {
        const int row = it / (COUT / VEC);
        const int col = (it % (COUT / VEC)) * VEC;
        *reinterpret_cast<float4*>(Bs + row * COUT + col) =
            *reinterpret_cast<const float4*>(
                wk + ((long long)k * cin + cc * CK + row) * COUT + col);
      }
      __syncthreads();
      // ---- contract the chunk ---------------------------------------------
      const int p = tid & (TP - 1), s = tid / TP;
#pragma unroll 4
      for (int kc = 0; kc < CK; ++kc) {
        const float av = As[p * AS_LD + kc];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          facc[j] += av * Bs[kc * COUT + s * CPT + j];
      }
    }
  }

  // ---- epilogue: + bias, NHWC store ---------------------------------------
  const int p = tid & (TP - 1), s = tid / TP;
  const int pix = p0 + p;
  if (pix < npix) {
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      out[(long long)pix * COUT + s * CPT + j] = facc[j] + bias[s * CPT + j];
  }
}

// ---- bf16 instance ----------------------------------------------------------

constexpr int TH = 8, TW = 16;  // output pixel tile (rows x columns)
constexpr int BP = TH * TW;     // output pixels per block
constexpr int MIN_BLOCKS = 2;   // resident blocks an SM (__launch_bounds__)
constexpr int RAW_LD = 48;      // raw values a pixel and block (6 x 16 B)
constexpr int A_LD = CK + 8;    // A tile row stride (bf16), padded by 16 B

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // one cvt
  return *reinterpret_cast<const uint32_t*>(&p);
}

// tanh(v) = 1 - 2 / (e^(2v) + 1) and sigmoid(v) = 1 / (1 + e^-v) through
// ex2.approx and a fast divide: ~1e-6 absolute, against ~4e-3 relative for
// the bf16 residue itself; they saturate to +-1 and 0 / 1 at the far ends.
__device__ __forceinline__ float tanh_prep(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

__device__ __forceinline__ float sigmoid_prep(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// dst[8] += w * (8 bf16 of u)
__device__ __forceinline__ void blend8(float* dst, const uint4& u, float w) {
  const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = fmaf(__uint_as_float(q[i] << 16), w, dst[2 * i]);
    dst[2 * i + 1] = fmaf(__uint_as_float(q[i] & 0xffff0000u), w,
                          dst[2 * i + 1]);
  }
}

template <int COUT>
struct Bf16Smem {
  static constexpr int B_LD = COUT + 8;  // B tile and epilogue row stride
  static constexpr int RAW_ELEMS = 3 * BP * RAW_LD;
  static constexpr int A_STAGE = BP * A_LD;
  static constexpr int B_STAGE = CK * B_LD;
  static constexpr int BYTES = 2 * (RAW_ELEMS + 2 * A_STAGE + 2 * B_STAGE);
  static constexpr int C_ELEMS = BP * B_LD;  // epilogue tile, over raw + A
  static_assert(C_ELEMS <= RAW_ELEMS + 2 * A_STAGE, "epilogue tile fits");
};

// NV = 16-byte vectors (8 channels each) per sampling item: 2 when Cin/G is
// a multiple of 16, else 1.
template <int COUT, int NV>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
dcn_raw_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ res_y,
             const __nv_bfloat16* __restrict__ res_x,
             const __nv_bfloat16* __restrict__ mlog,
             const float* __restrict__ flow_y,
             const float* __restrict__ flow_x,
             const __nv_bfloat16* __restrict__ wk,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
             int H, int W, int cin, int G, int A, long long raw_stride,
             float mrm) {
  using S = Bf16Smem<COUT>;
  constexpr int IPP = CK / (8 * NV);         // items per pixel per K-step
  constexpr int NI = BP * IPP / NTHREADS;    // items per thread (2 or 1)
  constexpr int NT = COUT / 16;              // n8 tiles per warp (Cout / 2)
  constexpr int B_LD = S::B_LD;
  static_assert(NI * NTHREADS == BP * IPP, "items divide evenly");

  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __nv_bfloat16* const raw_s = smem;                 // [3][BP][RAW_LD]
  __nv_bfloat16* const a_s = raw_s + S::RAW_ELEMS;   // [2][BP][A_LD]
  __nv_bfloat16* const b_s = a_s + 2 * S::A_STAGE;   // [2][CK][B_LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW, b = blockIdx.z;
  const int cg = cin / G, ga = G / A;
  const int nsteps = 9 * (cin / CK);
  // flattened pixel index of tile pixel p, or -1 outside the image
  auto pixel = [&](int p) -> int {
    const int y = ty0 + p / TW, xx = tx0 + p % TW;
    return (y < H && xx < W) ? (b * H + y) * W + xx : -1;
  };
  // the three raw blocks by index (an indexed array would sit in local memory)
  auto raw_block = [&](int blk) {
    return blk == 0 ? res_y : blk == 1 ? res_x : mlog;
  };
  // each raw block's data pointer in elements; masked to 3 bits with a
  // pixel's run offset, it gives where the run starts in its first staged
  // 16-byte chunk
  const unsigned raw_mis[3] = {
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(res_y) >> 1),
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(res_x) >> 1),
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(mlog) >> 1)};

  // Stage the three raw blocks' runs of chunk c (groups gs..ge, 9 taps each)
  // for the tile's pixels: 16-byte aligned windows, <= 6 chunks a pixel.
  auto stage_raw = [&](int c) {
    const int gs = c * CK / cg, ge = (c * CK + CK - 1) / cg;
    const int run_bytes = (ge - gs + 1) * 9 * 2;
#pragma unroll 1
    for (int i = 0; i < 3 * BP * 6 / NTHREADS; ++i) {
      const int it = tid + i * NTHREADS;
      const int blk = it / (BP * 6), p = (it / 6) % BP, w = it % 6;
      const int pix = pixel(p);
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(
          raw_block(blk) + (pix < 0 ? 0 : pix) * raw_stride + gs * 9);
      const uintptr_t lo = a0 & ~uintptr_t(15);
      const uintptr_t hi = (a0 + run_bytes + 15) & ~uintptr_t(15);
      const bool in = pix >= 0 && lo + 16 * w < hi;
      cp_async16(raw_s + (blk * BP + p) * RAW_LD + w * 8,
                 reinterpret_cast<const void*>(lo + (in ? 16 * w : 0)),
                 in ? 16 : 0);
    }
  };
  // Stage W[k, c*CK : c*CK + CK, :] of step s.
  auto stage_w = [&](int s) {
    const int c = s / 9, k = s % 9;
    __nv_bfloat16* dst = b_s + (s & 1) * S::B_STAGE;
    for (int it = tid; it < CK * COUT / 8; it += NTHREADS) {
      const int row = it / (COUT / 8), col = (it % (COUT / 8)) * 8;
      cp_async16(dst + row * B_LD + col,
                 wk + ((long long)k * cin + c * CK + row) * COUT + col, 16);
    }
  };

  // A thread's sampling items are tile pixels (tid + i * NTHREADS) / IPP,
  // all at the same vector j of the chunk.
  const int j = tid % IPP;
  const __nv_bfloat16* const xb = x + (long long)b * H * W * cin;
  const int row_elems = W * cin;  // one image row of x
  float fly[NI], flx[NI];  // the items' anchor flow in the current chunk

  // The flow of each item's anchor in chunk c: read once a chunk.
  auto load_flows = [&](int c) {
    const int a = (c * CK + j * 8 * NV) / cg / ga;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int pix = pixel((tid + i * NTHREADS) / IPP);
      fly[i] = pix < 0 ? 0.0f : __ldg(flow_y + (long long)pix * A + a);
      flx[i] = pix < 0 ? 0.0f : __ldg(flow_x + (long long)pix * A + a);
    }
  };
  // Item i of step s into A's stage s & 1: its prep once per (pixel, group,
  // tap) whenever NV vectors cover the group, then one vector at a time,
  // four corner loads in flight (a thread holds 16 bytes x 4, not x 4 x NV x
  // NI, which keeps the 64 accumulators of Cout = 128 out of local memory).
  auto sample = [&](int s, int i) {
    const int c = s / 9, k = s % 9;
    const int gs = c * CK / cg;
    const int c0 = c * CK + j * 8 * NV;   // first channel of the item
    const int r = (c0 / cg - gs) * 9 + k; // (group, tap) within the run
    const int p = (tid + i * NTHREADS) / IPP;
    const int y = ty0 + p / TW, xx = tx0 + p % TW;
    // corners (y0,x0), (y0,x1), (y1,x0), (y1,x1): weights with the mask
    // folded in, 0 outside the image; addresses from one base, since only
    // a corner inside the image is read
    float cw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    long long base = c0;
    if (y < H && xx < W) {
      const int pix = (b * H + y) * W + xx;
      const unsigned e = static_cast<unsigned>(pix * raw_stride) + gs * 9;
      float v[3];
#pragma unroll
      for (int blk = 0; blk < 3; ++blk)
        v[blk] = __bfloat162float(
            raw_s[(blk * BP + p) * RAW_LD + ((raw_mis[blk] + e) & 7u) + r]);
      const float sy = (float)(y + k / 3 - 1) + mrm * tanh_prep(v[0]) + fly[i];
      const float sx = (float)(xx + k % 3 - 1) + mrm * tanh_prep(v[1]) + flx[i];
      const float m = sigmoid_prep(v[2]);
      const float y0 = floorf(sy), x0 = floorf(sx);
      const float ly = sy - y0, lx = sx - x0;
      const bool vy0 = y0 >= 0.0f && y0 <= (float)(H - 1);
      const bool vy1 = y0 + 1.0f >= 0.0f && y0 + 1.0f <= (float)(H - 1);
      const bool vx0 = x0 >= 0.0f && x0 <= (float)(W - 1);
      const bool vx1 = x0 + 1.0f >= 0.0f && x0 + 1.0f <= (float)(W - 1);
      cw[0] = (vy0 && vx0) ? (1.0f - ly) * (1.0f - lx) * m : 0.0f;
      cw[1] = (vy0 && vx1) ? (1.0f - ly) * lx * m : 0.0f;
      cw[2] = (vy1 && vx0) ? ly * (1.0f - lx) * m : 0.0f;
      cw[3] = (vy1 && vx1) ? ly * lx * m : 0.0f;
      // (y0, x0) clamped to [-1, H-1] x [-1, W-1]: beyond that no corner
      // is read, and the index stays in range
      const int iy = (int)fminf(fmaxf(y0, -1.0f), (float)(H - 1));
      const int ix = (int)fminf(fmaxf(x0, -1.0f), (float)(W - 1));
      base = (long long)(iy * W + ix) * cin + c0;
    }
    const long long coff[4] = {0, cin, row_elems, row_elems + cin};
    __nv_bfloat16* dst = a_s + (s & 1) * S::A_STAGE + p * A_LD + j * 8 * NV;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      uint4 cu[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cu[q] = cw[q] != 0.0f
            ? __ldg(reinterpret_cast<const uint4*>(xb + base + coff[q] + v * 8))
            : make_uint4(0u, 0u, 0u, 0u);
      float acc8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < 4; ++q) blend8(acc8, cu[q], cw[q]);
      *reinterpret_cast<uint4*>(dst + v * 8) =
          make_uint4(pack_bf16(acc8[0], acc8[1]), pack_bf16(acc8[2], acc8[3]),
                     pack_bf16(acc8[4], acc8[5]), pack_bf16(acc8[6], acc8[7]));
    }
  };
  // Step s's samples into A's stage s & 1.
  auto gather = [&](int s) {
    if (s % 9 == 0) load_flows(s / 9);
#pragma unroll
    for (int i = 0; i < NI; ++i) sample(s, i);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

  // This warp's 32 pixels x Cout/2 of step s: 2 k16 slices of the chunk.
  auto contract = [&](int s) {
    const __nv_bfloat16* as = a_s + (s & 1) * S::A_STAGE;
    const __nv_bfloat16* bs = b_s + (s & 1) * S::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(fa[mt], as + (wm * 32 + mt * 16 + (lane & 15)) * A_LD +
                            kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (kk * 16 + (lane & 15)) * B_LD +
                             wn * (COUT / 2) + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], fa[mt], r[0], r[1]);
          mma16816(acc[mt][2 * np + 1], fa[mt], r[2], r[3]);
        }
      }
    }
  };

  // ---- prologue: raw chunk 0 and W of step 0, then step 0's samples ---------
  stage_raw(0);
  stage_w(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  gather(0);

  // ---- main loop: one barrier a K-step, two where a chunk opens -------------
  for (int s = 0; s < nsteps; ++s) {
    // step s's A (gathered last iteration) and B (cp.async) are complete,
    // and every warp is done with step s-1's stages
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 == nsteps) {
      contract(s);
      break;
    }
    stage_w(s + 1);
    if ((s + 1) % 9 == 0) {
      // step s+1 opens the next chunk; its raw runs replace this chunk's,
      // whose last reader was gather(s), under step s's MMAs
      stage_raw((s + 1) / 9);
      cp_async_commit();
      contract(s);
      cp_async_wait_all();
      __syncthreads();
      gather(s + 1);
      continue;
    }
    cp_async_commit();
    contract(s);
    gather(s + 1);
  }

  // ---- epilogue: + bias, bf16, through shared memory, 16-byte NHWC stores ---
  __syncthreads();  // the raw and A stages are free
  __nv_bfloat16* cs = raw_s;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * (COUT / 2) + nt * 8 + t4 * 2;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm * 32 + mt * 16 + gq;
      *reinterpret_cast<uint32_t*>(cs + row * B_LD + col) =
          pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      *reinterpret_cast<uint32_t*>(cs + (row + 8) * B_LD + col) =
          pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
  __syncthreads();
  for (int it = tid; it < BP * COUT / 8; it += NTHREADS) {
    const int p = it / (COUT / 8), col = (it % (COUT / 8)) * 8;
    const int pix = pixel(p);
    if (pix >= 0)
      *reinterpret_cast<uint4*>(out + (long long)pix * COUT + col) =
          *reinterpret_cast<const uint4*>(cs + p * B_LD + col);
  }
}

template <int COUT>
cudaError_t launch_f32(const void* x, const void* ry, const void* rx,
                       const void* ml, const void* fy, const void* fx,
                       const void* wk, const void* bias, void* out, int npix,
                       int H, int W, int cin, int G, int A,
                       long long raw_stride, float mrm, cudaStream_t stream) {
  const dim3 grid((npix + TP - 1) / TP);
  dcn_raw_f32<COUT><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ry),
      static_cast<const float*>(rx), static_cast<const float*>(ml),
      static_cast<const float*>(fy), static_cast<const float*>(fx),
      static_cast<const float*>(wk), static_cast<const float*>(bias),
      static_cast<float*>(out), npix, H, W, cin, G, A, raw_stride, mrm);
  return cudaGetLastError();
}

template <int COUT, int NV>
cudaError_t launch_bf16(const void* x, const void* ry, const void* rx,
                        const void* ml, const void* fy, const void* fx,
                        const void* wk, const void* bias, void* out, int npix,
                        int H, int W, int cin, int G, int A,
                        long long raw_stride, float mrm, cudaStream_t stream) {
  constexpr int SMEM = Bf16Smem<COUT>::BYTES;
  // shared memory above 48 KB is opt-in (set on every launch: the
  // attribute belongs to the current device's context)
  const cudaError_t e = cudaFuncSetAttribute(
      dcn_raw_bf16<COUT, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return e;
  using B16 = __nv_bfloat16;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, npix / (H * W));
  dcn_raw_bf16<COUT, NV><<<grid, NTHREADS, SMEM, stream>>>(
      static_cast<const B16*>(x), static_cast<const B16*>(ry),
      static_cast<const B16*>(rx), static_cast<const B16*>(ml),
      static_cast<const float*>(fy), static_cast<const float*>(fx),
      static_cast<const B16*>(wk), static_cast<const float*>(bias),
      static_cast<B16*>(out), H, W, cin, G, A, raw_stride, mrm);
  return cudaGetLastError();
}

template <int COUT>
cudaError_t dispatch(bool bf16, const void* x, const void* ry, const void* rx,
                     const void* ml, const void* fy, const void* fx,
                     const void* wk, const void* bias, void* out, int npix,
                     int H, int W, int cin, int G, int A,
                     long long raw_stride, float mrm, cudaStream_t s) {
  if (!bf16)
    return launch_f32<COUT>(x, ry, rx, ml, fy, fx, wk, bias, out, npix, H, W,
                            cin, G, A, raw_stride, mrm, s);
  if ((cin / G) % 16 == 0)
    return launch_bf16<COUT, 2>(x, ry, rx, ml, fy, fx, wk, bias, out, npix, H,
                                W, cin, G, A, raw_stride, mrm, s);
  return launch_bf16<COUT, 1>(x, ry, rx, ml, fy, fx, wk, bias, out, npix, H,
                              W, cin, G, A, raw_stride, mrm, s);
}

}  // namespace

extern "C" {

// Launches one DCN on `stream` and returns the launch's CUDA error code
// (0 = launched), or -1 for a Cout the kernel is not instantiated for.
// is_bf16 selects the element type of x / res_y / res_x / mask_logits / wk /
// out (else float32); flows and bias are always float32. wk is
// (9, Cin, Cout), tap-major. The bf16 instance needs x, wk and out 16-byte
// aligned, Cin % 32 == 0 and (Cin / G) % 8 == 0 (the wrapper checks).
int dcn_raw_forward(int is_bf16, const void* x, const void* res_y,
                    const void* res_x, const void* mask_logits,
                    const void* flow_y, const void* flow_x, const void* wk,
                    const void* bias, void* out, int npix, int H, int W,
                    int cin, int cout, int G, int A, long long raw_stride,
                    float mrm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  cudaError_t rc;
  switch (cout) {
    case 32:
      rc = dispatch<32>(bf, x, res_y, res_x, mask_logits, flow_y, flow_x, wk,
                        bias, out, npix, H, W, cin, G, A, raw_stride, mrm, s);
      break;
    case 64:
      rc = dispatch<64>(bf, x, res_y, res_x, mask_logits, flow_y, flow_x, wk,
                        bias, out, npix, H, W, cin, G, A, raw_stride, mrm, s);
      break;
    case 128:
      rc = dispatch<128>(bf, x, res_y, res_x, mask_logits, flow_y, flow_x, wk,
                         bias, out, npix, H, W, cin, G, A, raw_stride, mrm, s);
      break;
    default:
      return -1;
  }
  return static_cast<int>(rc);
}

const char* dcn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
