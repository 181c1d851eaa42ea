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
// k / v pointers D and 2*D past q: no transposes and no copies. Rows are
// never contiguous with each other: every copy is one 16-byte chunk of one
// row. The output is written (B, S, H, D) contiguous, which the projection
// takes as (B, S, H*D).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 bf16 TFLOP/s), bf16, D = 64,
// at the BlurUNet's three serving shapes (10-frame window, B = 1):
//   S = 1024, BH = 40: 4*BH*S*S*D = 1.07e10 FLOP -> 0.0109 ms; q, k, v, o
//     are 21 MB -> 0.0063 ms: bound by operations.
//   S = 256, BH = 80: 2.7e9 FLOP -> 0.0027 ms; 10.5 MB -> 0.0031 ms:
//     bound by bytes (and, at a few microseconds, by latency).
//   S = 64, BH = 80: bound by bytes (2.6 MB, 0.0008 ms) and latency.
//
// The bf16 design (FlashAttention-2 forward with mma.sync). A block owns one
// (batch*head, query tile); each warp owns RM 16-row slices of it and keeps
// their Q fragments, f32 output accumulators and row max / sum in registers.
// The block walks over 64-key tiles of K and V:
// - Pipeline, 2 stages: K and V tiles go through a 2-stage shared-memory
//   ring filled by cp.async.cg (16 bytes a thread). Tile j+1 is issued right
//   after the barrier that opens tile j, so its loads are in flight while
//   tile j's two products and softmax run; one wait_group 0 + __syncthreads
//   a tile. Q goes through cp.async once, with tile 0, into stage 1 (free
//   until tile 1 is issued), then into registers; a barrier frees the stage.
//   36 KB of static shared memory at D = 64, so no dynamic opt-in. Rows at
//   or past S are zero-filled by cp.async's src-size operand (0).
// - Fragments: ldmatrix.x4 reads Q (A operand) and K (B operand of Q K^T);
//   ldmatrix.x4.trans reads V in its natural (key, d) row-major tile as the
//   B operand of P V, so V is never transposed in shared memory.
// - Bank conflicts: rows are padded by 8 bf16 (16 bytes), so the 8 row
//   addresses of an 8x8 ldmatrix tile (stride 144 B at D = 64, 80 B at 32)
//   start on 8 distinct 4-bank groups, and a warp's 16-byte cp.async stores
//   fill whole 128-byte rows. No swizzle.
// - Products: both run on the tensor cores as mma.sync m16n8k16 bf16 -> f32.
//   The S = Q K^T accumulators are reused in registers as the A operand of
//   P V (rounded to bf16 there only, one cvt per pair), so P never leaves
//   registers.
// - Softmax: row max of the raw scores, then one FFMA (s * scale*log2e - m)
//   before ex2.approx.ftz; max and sum stay f32 in log2 units. The ragged
//   last tile is peeled off the loop (attend_tile<MASK = true>), the only
//   one whose keys past S are masked to -inf; query rows past S are not
//   stored.
// - Query tile by S (chosen in dispatch_bf16, no caller knob):
//   S > 256: 128 queries, 4 warps x 32 rows. Each query tile re-reads all of
//     its head's K and V from L2: at S = 1024, BH = 40 that is
//     8 tiles x 2 x 1024 x 64 x 2 B x 40 = 84 MB, half of the 168 MB that
//     64-query tiles read. Each K / V fragment read from shared memory feeds
//     two MMAs (the warp's two 16-row slices), halving ldmatrix traffic per
//     FLOP. About 250 registers a thread: 2 blocks an SM, so the 320 blocks
//     of S = 1024 run in two waves; capping registers at 168 for 3 blocks
//     an SM makes ptxas spill.
//   64 < S <= 256: 64 queries, 4 warps x 16 rows: 320 blocks at S = 256,
//     BH = 80 (2.4 per SM on 132 SMs, all resident at once).
//   S <= 64: 16 queries, one warp: 320 blocks at S = 64, BH = 80, where a
//     64-query tile gave 80 blocks and left 52 SMs idle.
//
// A float32 instance (CUDA-core FMAs, one thread per query row, the online
// softmax per key) serves the f32 parity runs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // f32 instance: queries (threads) per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // one cvt
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the MUFU unit; results below 2^-126 flush to 0 (a probability that
// small is nothing beside the row's largest, which is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cp.async rows [r0, r0 + ROWS) of one head (row stride ss) into dst (row
// stride D + 8); rows at or past S are zero-filled.
template <int ROWS, int D, int NTHREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int S, long long ss, int tid) {
  constexpr int VPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * VPR % NTHREADS == 0, "chunks must divide evenly");
#pragma unroll
  for (int i = 0; i < ROWS * VPR / NTHREADS; ++i) {
    const int it = tid + i * NTHREADS;
    const int r = it / VPR, c = (it % VPR) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (D + 8) + c,
               src + (long long)(in ? r0 + r : 0) * ss + c, in ? 16 : 0);
  }
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same), a2 (row g, cols
//      2t+8..), a3 (row g+8, cols 2t+8..);
//   B: b0 (rows 2t..2t+1, col g), b1 (rows 2t+8.., col g);
//   C: c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same).
//
// One 64-key tile for one warp's RM 16-row slices: S = Q K^T, the online
// softmax, O += P V. Kt and Vt are the tile's (key, d) rows (stride D + 8).
// MASK (the last tile only): keys at or past `valid` get -inf.
template <int D, int RM, bool MASK>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qa)[RM][D / 16][4], const __nv_bfloat16* Kt,
    const __nv_bfloat16* Vt, int valid, float scale_log2, int lane,
    float (&o)[RM][D / 8][4], float (&mrow)[RM][2], float (&lrow)[RM][2]) {
  constexpr int LD = D + 8;
  constexpr int NS = BK / 8;  // 8-key column tiles of S
  constexpr int NO = D / 8;   // 8-wide column tiles of O
  constexpr int KD = D / 16;  // 16-deep steps of Q K^T
  const int t4 = lane & 3;

  float s[RM][NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    uint32_t kb[KD][2];
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {  // keys nt*8.., d c*32 + 0/8/16/24
      uint32_t r[4];
      ldsm_x4(r, Kt + (nt * 8 + (lane & 7)) * LD + c * 32 + (lane >> 3) * 8);
      kb[2 * c][0] = r[0];
      kb[2 * c][1] = r[1];
      kb[2 * c + 1][0] = r[2];
      kb[2 * c + 1][1] = r[3];
    }
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      s[m][nt][0] = s[m][nt][1] = s[m][nt][2] = s[m][nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        mma16816(s[m][nt], qa[m][kk], kb[kk][0], kb[kk][1]);
    }
  }
  if (MASK) {
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + t4 * 2 + (e & 1) >= valid) s[m][nt][e] = -INFINITY;
  }

#pragma unroll
  for (int m = 0; m < RM; ++m) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[m][nt][0], s[m][nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[m][nt][2], s[m][nt][3]));
    }
    // every tile holds a key < S, so the new maxima are finite
    const float mn0 = fmaxf(mrow[m][0], quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(mrow[m][1], quad_max(mx1) * scale_log2);
    const float al0 = ex2(mrow[m][0] - mn0), al1 = ex2(mrow[m][1] - mn1);
    mrow[m][0] = mn0;
    mrow[m][1] = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[m][nt][0] = ex2(fmaf(s[m][nt][0], scale_log2, -mn0));
      s[m][nt][1] = ex2(fmaf(s[m][nt][1], scale_log2, -mn0));
      s[m][nt][2] = ex2(fmaf(s[m][nt][2], scale_log2, -mn1));
      s[m][nt][3] = ex2(fmaf(s[m][nt][3], scale_log2, -mn1));
      rs0 += s[m][nt][0] + s[m][nt][1];
      rs1 += s[m][nt][2] + s[m][nt][3];
    }
    lrow[m][0] = lrow[m][0] * al0 + rs0;
    lrow[m][1] = lrow[m][1] * al1 + rs1;
#pragma unroll
    for (int jo = 0; jo < NO; ++jo) {
      o[m][jo][0] *= al0;
      o[m][jo][1] *= al0;
      o[m][jo][2] *= al1;
      o[m][jo][3] *= al1;
    }
  }
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    // the S accumulators of key tiles 2ks, 2ks+1 are one A operand
    uint32_t pa[RM][4];
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      pa[m][0] = pack_bf16(s[m][2 * ks][0], s[m][2 * ks][1]);
      pa[m][1] = pack_bf16(s[m][2 * ks][2], s[m][2 * ks][3]);
      pa[m][2] = pack_bf16(s[m][2 * ks + 1][0], s[m][2 * ks + 1][1]);
      pa[m][3] = pack_bf16(s[m][2 * ks + 1][2], s[m][2 * ks + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {  // keys ks*16 + 0/8, d dp*16 + 0/8
      uint32_t r[4];
      ldsm_x4_trans(r, Vt + (ks * 16 + (lane & 15)) * LD + dp * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        mma16816(o[m][2 * dp], pa[m], r[0], r[1]);
        mma16816(o[m][2 * dp + 1], pa[m], r[2], r[3]);
      }
    }
  }
}

// NW warps, each owning RM 16-row slices: NW * RM * 16 queries a block.
template <int D, int NW, int RM>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int S, int H, long long sb,
               long long ss, long long sh, float scale_log2) {
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  constexpr int QT = NW * RM * 16;  // queries per block
  constexpr int NTHREADS = NW * 32;
  constexpr int LD = D + 8;         // padded row stride of every tile
  constexpr int STAGE = 2 * BK * LD;  // one ring stage: K tile, then V tile
  constexpr int NO = D / 8;
  static_assert(QT <= 2 * BK, "the Q tile is staged in one ring stage");
  // the ring; Q passes through stage 1 before tile 1 is loaded there
  __shared__ __align__(16) __nv_bfloat16 ring[2 * STAGE];
  __nv_bfloat16* const Qs = ring + STAGE;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * QT;
  const long long base = (long long)b * sb + (long long)h * sh;
  const __nv_bfloat16 *qh = q + base, *kh = k + base, *vh = v + base;
  const int ntiles = (S + BK - 1) / BK, nfull = S / BK;

  load_rows<QT, D, NTHREADS>(Qs, qh, q0, S, ss, tid);
  load_rows<BK, D, NTHREADS>(ring, kh, 0, S, ss, tid);
  load_rows<BK, D, NTHREADS>(ring + BK * LD, vh, 0, S, ss, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[RM][D / 16][4];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qa[m][kk], Qs + ((warp * RM + m) * 16 + (lane & 15)) * LD +
                             kk * 16 + (lane >> 4) * 8);
  __syncthreads();  // every warp holds its Q fragments: stage 1 is free

  float o[RM][NO][4];
  float mrow[RM][2], lrow[RM][2];  // running max (log2 units), partial sums
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int jo = 0; jo < NO; ++jo)
      o[m][jo][0] = o[m][jo][1] = o[m][jo][2] = o[m][jo][3] = 0.0f;
    mrow[m][0] = mrow[m][1] = -INFINITY;
    lrow[m][0] = lrow[m][1] = 0.0f;
  }

  // Wait for tile j, then put tile j+1 in flight into the stage that tile
  // j-1 held. One commit group is in flight at a time.
  auto advance = [&](int j) {
    if (j > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile j visible to all; every warp is done with j-1
    }
    if (j + 1 < ntiles) {
      __nv_bfloat16* st = ring + ((j + 1) & 1) * STAGE;
      load_rows<BK, D, NTHREADS>(st, kh, (j + 1) * BK, S, ss, tid);
      load_rows<BK, D, NTHREADS>(st + BK * LD, vh, (j + 1) * BK, S, ss, tid);
      cp_async_commit();
    }
  };
  for (int j = 0; j < nfull; ++j) {
    advance(j);
    const __nv_bfloat16* st = ring + (j & 1) * STAGE;
    attend_tile<D, RM, false>(qa, st, st + BK * LD, BK, scale_log2, lane, o,
                              mrow, lrow);
  }
  if (nfull < ntiles) {  // the ragged last tile
    advance(nfull);
    const __nv_bfloat16* st = ring + (nfull & 1) * STAGE;
    attend_tile<D, RM, true>(qa, st, st + BK * LD, S - nfull * BK, scale_log2,
                             lane, o, mrow, lrow);
  }

  // ---- epilogue: divide by the row sums, (B, S, H, D) store ----------------
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const float inv0 = 1.0f / quad_sum(lrow[m][0]);
    const float inv1 = 1.0f / quad_sum(lrow[m][1]);
    const int row0 = q0 + (warp * RM + m) * 16 + g, row1 = row0 + 8;
    __nv_bfloat16* o0 = out + (((long long)b * S + row0) * H + h) * D + t4 * 2;
    __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
    for (int jo = 0; jo < NO; ++jo) {
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(o0 + jo * 8) =
            pack_bf16(o[m][jo][0] * inv0, o[m][jo][1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(o1 + jo * 8) =
            pack_bf16(o[m][jo][2] * inv1, o[m][jo][3] * inv1);
    }
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

template <int D, int NW, int RM>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, long long sb,
                        long long ss, long long sh, float scale_log2,
                        cudaStream_t stream) {
  constexpr int QT = NW * RM * 16;
  const dim3 grid((S + QT - 1) / QT, B * H);
  flash_fwd_bf16<D, NW, RM><<<grid, NW * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, sb, ss, sh, scale_log2);
  return cudaGetLastError();
}

// The query tile by S (see the note at the top).
template <int D>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, long long sb,
                          long long ss, long long sh, float scale_log2,
                          cudaStream_t stream) {
  if (S > 256)
    return launch_bf16<D, 4, 2>(q, k, v, out, B, S, H, sb, ss, sh, scale_log2,
                                stream);
  if (S > 64)
    return launch_bf16<D, 4, 1>(q, k, v, out, B, S, H, sb, ss, sh, scale_log2,
                                stream);
  return launch_bf16<D, 1, 1>(q, k, v, out, B, S, H, sb, ss, sh, scale_log2,
                              stream);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, long long sb, long long ss,
                       long long sh, float scale_log2, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32<D><<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, sb, ss,
      sh, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one attention on `stream` and returns the launch's CUDA error
// code (0 = launched), or -1 for a head dim the kernel is not instantiated
// for. is_bf16 selects bf16 q / k / v / out (else float32). Strides are in
// elements and shared by q, k and v; out is (B, S, H, D) contiguous. The
// bf16 kernel takes the row max of unscaled scores, so scale must be > 0.
int flash_attn_forward(int is_bf16, const void* q, const void* k,
                       const void* v, void* out, int B, int S, int H, int D,
                       long long sb, long long ss, long long sh, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * LOG2E;
  cudaError_t rc;
  if (D == 32)
    rc = is_bf16 ? dispatch_bf16<32>(q, k, v, out, B, S, H, sb, ss, sh, sl2, st)
                 : launch_f32<32>(q, k, v, out, B, S, H, sb, ss, sh, sl2, st);
  else if (D == 64)
    rc = is_bf16 ? dispatch_bf16<64>(q, k, v, out, B, S, H, sb, ss, sh, sl2, st)
                 : launch_f32<64>(q, k, v, out, B, S, H, sb, ss, sh, sl2, st);
  else
    return -1;
  return static_cast<int>(rc);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
