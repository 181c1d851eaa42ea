// The int8 / bf16 tensor-core dot probe, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by flair_tpu_torch/tools/probe_int8.py.
//
// Replaces: tools/probe_int8.py::dot_kernel (pallas_call sites :118 in
// run(), three variants, and :150 in check_numerics()).
//
// What it computes, for every grid step g of a (GRID, UVP, BC) and b
// (REPS, UVP, 128):
//   out[g] (BC, 128) = sum_{r < REPS} a[g]^T (BC, UVP) . b[r] (UVP, 128)
// in three variants, as the TPU probe runs them:
//   0  bf16 x bf16 -> f32    mma.sync m16n8k16
//   1  s8 x s8 -> s32        mma.sync m16n8k32 .s8.s8.s32
//   2  f32 a quantised while staging (cvt.rni.sat.s8.f32 of a * 127, round
//      half to even as jnp.round) x s8 b -> s32, the s8 mma
// Each grid step does its REPS dots: the REPS x UVP contraction is walked
// as one K loop, and a[g]'s slice is staged (and, in variant 2, quantised)
// again for every r, as the TPU kernel reads a_ref[0] inside its REPS loop
// (the TPU probe's note :83-86: work hoisted out of that loop is not
// measured).
//
// Layouts are the TPU probe's, taken as given: both operands are K-outer
// (a is (K = UVP, M = BC), b is (K, N = 128)). mma.sync wants A K-contiguous
// (row) and B K-contiguous (col).
// - bf16: ldmatrix.trans reads both in their natural layout (as K1 and K2
//   read B), staged with 16-byte cp.async.
// - s8: ldmatrix.trans moves 16-bit elements only and the s8 mma exists
//   only as .row.col, so staging transposes bytes: a thread loads 16 K-rows
//   of 4 bytes (one 32-bit load each, coalesced along M / N across the
//   warp), transposes 4 x 4 byte blocks with __byte_perm, and stores four
//   16-byte K runs, one a row of M / N. Rows are 64 bytes (BK = 64 K) with
//   their 16-byte chunks XOR-swizzled by row, so ldmatrix's 8-row reads hit
//   8 distinct bank groups and the staging stores at most 2 rows a group.
//   Loads for step s + 1 are issued before step s's MMAs and stored after.
//
// Blocks: 384 threads (12 warps as 6 along M x 2 along N, 32 x 64 outputs
// a warp), a 192 x 128 tile of one grid step's output (BC = 576 is three
// blocks), one block an SM. Output f32 / s32, written from the accumulators.
//
// What bounds it: 2 * REPS * GRID * UVP * BC * 128 = 1.24e12 operations at
// UVP 256 against 989e12 (bf16) / 1979e12 (int8) a second: 1.25 / 0.63 ms,
// far above the bytes (a, b and out once: 0.6 GB bf16, 0.18 ms). Re-staging
// a[g]'s slice every rep moves REPS times a's bytes from L2 or L1 (9.7 GB
// bf16, 4.8 GB int8, 19 GB f32 at UVP 256), so the copies go through L1
// (cp.async.ca, ld.global.nc) and the launch asks for the smallest shared
// memory carveout that holds a block's 40-43 KB, leaving L1 the rest.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 192;        // output rows (of BC) a block
constexpr int BN = 128;        // output columns: all 128 lanes
constexpr int NTHREADS = 384;  // 12 warps: 6 (M) x 2 (N)
constexpr int WM = 32, WN = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L1 (.ca): a[g]'s slice is read again
// every rep and can stay there
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round(v * 127) to s8, half to even, saturating (cvt.rni.sat.s8.f32)
__device__ __forceinline__ uint32_t quant_s8(float v) {
  uint32_t q;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(q) : "f"(v * 127.0f));
  return q;
}

// bytes 0 of a, b, c, d -> one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 4 x 4 byte transpose: w[i] holds row i's bytes 0..3; t[j] gets byte j of
// rows 0..3
__device__ __forceinline__ void transpose4x4(const uint32_t* w, uint32_t* t) {
  const uint32_t p = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t q = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t r = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t u = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(p, r, 0x5410);
  t[1] = __byte_perm(p, r, 0x7632);
  t[2] = __byte_perm(q, u, 0x5410);
  t[3] = __byte_perm(q, u, 0x7632);
}

// ---- bf16 instance ---------------------------------------------------------

constexpr int BK16 = 32;              // K a step (two k16 slices)
constexpr int A16_LD = BM + 8;        // bf16 a K-row of the A stage
constexpr int B16_LD = BN + 8;        // bf16 a K-row of the B stage

__global__ void __launch_bounds__(NTHREADS, 1)
probe_dot_bf16(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
               int uvp, int bc, int reps) {
  __shared__ __align__(128) __nv_bfloat16 as[2][BK16 * A16_LD];
  __shared__ __align__(128) __nv_bfloat16 bs[2][BK16 * B16_LD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 6, wn = warp / 6;
  const int m0 = blockIdx.x * BM, g = blockIdx.y;
  const __nv_bfloat16* ag = a + (long long)g * uvp * bc + m0;
  const int ksteps = uvp / BK16, nsteps = reps * ksteps;

  auto stage = [&](int s) {
    const int r = s / ksteps, k0 = (s % ksteps) * BK16;
    __nv_bfloat16* ad = as[s & 1];
    __nv_bfloat16* bd = bs[s & 1];
    for (int it = tid; it < BK16 * BM / 8; it += NTHREADS) {
      const int row = it / (BM / 8), col = (it % (BM / 8)) * 8;
      cp_async16(ad + row * A16_LD + col,
                 ag + (long long)(k0 + row) * bc + col);
    }
    const __nv_bfloat16* br = b + ((long long)r * uvp + k0) * BN;
    for (int it = tid; it < BK16 * BN / 8; it += NTHREADS) {
      const int row = it / (BN / 8), col = (it % (BN / 8)) * 8;
      cp_async16(bd + row * B16_LD + col, br + row * BN + col);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  stage(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      stage(s + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* ab = as[s & 1];
    const __nv_bfloat16* bb = bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_trans(fa[mt], ab + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                       A16_LD +
                                   wm * WM + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, bb + (kk * 16 + (lane & 15)) * B16_LD + wn * WN +
                              np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
          mma_bf16(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const int gq = lane >> 2, t4 = lane & 3;
  float* og = out + ((long long)g * bc + m0) * BN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = wm * WM + mt * 16 + gq, col = wn * WN + nt * 8 + t4 * 2;
      *reinterpret_cast<float2*>(og + row * BN + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(og + (row + 8) * BN + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ---- s8 instances (variant 1: s8 a; variant 2: f32 a, quantised) ----------

constexpr int BK8 = 64;   // K bytes a step (two k32 slices); a row of the stage

// byte offset of (row, 16-byte chunk c) in a stage of 64-byte rows
__device__ __forceinline__ int swz(int row, int c) {
  return row * BK8 + ((c ^ ((row >> 1) ^ (row >> 3))) & 3) * 16;
}

template <bool QUANT>
__global__ void __launch_bounds__(NTHREADS, 1)
probe_dot_s8(const void* __restrict__ av, const int8_t* __restrict__ b,
             int* __restrict__ out, int uvp, int bc, int reps) {
  // A stage [m][k], B stage [n][k]: K-contiguous 64-byte rows
  __shared__ __align__(128) uint8_t as[2][BM * BK8];
  __shared__ __align__(128) uint8_t bs[2][BN * BK8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 6, wn = warp / 6;
  const int m0 = blockIdx.x * BM, g = blockIdx.y;
  const int ksteps = uvp / BK8, nsteps = reps * ksteps;
  // staging units: 16 K-rows x 4 M (or N) of one step; A has
  // (BK8 / 16) x (BM / 4) = 192 of them, B 128; threads 320.. stage nothing
  constexpr int A_UNITS = (BK8 / 16) * (BM / 4);
  constexpr int B_UNITS = (BK8 / 16) * (BN / 4);
  const bool is_a = tid < A_UNITS;
  const bool stager = tid < A_UNITS + B_UNITS;
  const int u = is_a ? tid : tid - A_UNITS;
  const int kg = is_a ? u / (BM / 4) : u / (BN / 4);   // 16-row K group
  const int cb = 4 * (is_a ? u % (BM / 4) : u % (BN / 4));  // first M / N
  using AT = typename std::conditional<QUANT, float, int8_t>::type;
  const AT* ag = static_cast<const AT*>(av) + (long long)g * uvp * bc + m0;

  // the unit's 16 K-rows x 4 bytes (s8), or 16 x 4 floats' bits (the
  // quantised A: row i, column j at w[4 * i + j])
  uint32_t w[QUANT ? 64 : 16];
  auto load = [&](int s) {
    if (!stager) return;
    const int r = s / ksteps, k0 = (s % ksteps) * BK8 + kg * 16;
    if (is_a) {
      if constexpr (QUANT) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              ag + (long long)(k0 + i) * bc + cb));
          w[4 * i] = __float_as_uint(v.x);
          w[4 * i + 1] = __float_as_uint(v.y);
          w[4 * i + 2] = __float_as_uint(v.z);
          w[4 * i + 3] = __float_as_uint(v.w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] = __ldg(reinterpret_cast<const uint32_t*>(
              ag + (long long)(k0 + i) * bc + cb));
      }
    } else {
      const int8_t* br = b + ((long long)r * uvp + k0) * BN + cb;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = __ldg(reinterpret_cast<const uint32_t*>(br + i * BN));
    }
  };
  // transpose (and quantise) into the stage: row cb + j gets the unit's 16
  // K bytes of column j as chunk kg
  auto store = [&](int s) {
    if (!stager) return;
    uint8_t* dst = is_a ? as[s & 1] : bs[s & 1];
    uint32_t rows[4][4];  // [j][word of 4 K]
    if (QUANT && is_a) {
      auto qa = [&](int i, int j) {  // K-row i, column j, quantised
        return quant_s8(__uint_as_float(w[4 * i + j]));
      };
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rows[j][q] = pack4(qa(4 * q, j), qa(4 * q + 1, j), qa(4 * q + 2, j),
                             qa(4 * q + 3, j));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t t[4];
        transpose4x4(w + 4 * q, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) rows[j][q] = t[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(dst + swz(cb + j, kg)) =
          make_uint4(rows[j][0], rows[j][1], rows[j][2], rows[j][3]);
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) load(s + 1);
    const uint8_t* ab = as[s & 1];
    const uint8_t* bb = bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < BK8 / 32; ++kk) {
      const int t = lane >> 3;
      uint32_t fa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(fa[mt], ab + swz(wm * WM + mt * 16 + (lane & 7) + (t & 1) * 8,
                                 2 * kk + (t >> 1)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t fb[4];
        ldsm_x4(fb, bb + swz(wn * WN + np * 16 + (lane & 7) + (t >> 1) * 8,
                             2 * kk + (t & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], fa[mt], fb[0], fb[1]);
          mma_s8(acc[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
        }
      }
    }
    if (s + 1 < nsteps) store(s + 1);
    __syncthreads();
  }

  const int gq = lane >> 2, t4 = lane & 3;
  int* og = out + ((long long)g * bc + m0) * BN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int row = wm * WM + mt * 16 + gq, col = wn * WN + nt * 8 + t4 * 2;
      *reinterpret_cast<int2*>(og + row * BN + col) =
          make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(og + (row + 8) * BN + col) =
          make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// One launch of `kernel` on `stream` after the carveout hint (percent of
// the SM's shared memory, set on every launch: the attribute belongs to the
// current device's context); returns the CUDA error code.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 blocks, cudaStream_t stream,
                   A... args) {
  constexpr int CARVEOUT = 25;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, CARVEOUT);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, NTHREADS, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one probe on `stream`: variant 0 (a, b bf16; out f32), 1 (a, b
// int8; out int32), 2 (a f32 in [0, 1], quantised; b int8; out int32).
// a (grid, uvp, bc), b (reps, uvp, 128), out (grid, bc, 128), contiguous
// and 16-byte aligned. Needs bc % 192 == 0 and uvp % 64 == 0 (the wrapper
// checks). Returns the launch's CUDA error code, or -1 for another variant.
int probe_dot(int variant, const void* a, const void* b, void* out, int grid,
              int uvp, int bc, int reps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks(bc / BM, grid);
  const auto* b8 = static_cast<const int8_t*>(b);
  int* o32 = static_cast<int*>(out);
  cudaError_t e;
  switch (variant) {
    case 0:
      e = launch(probe_dot_bf16, blocks, s,
                 static_cast<const __nv_bfloat16*>(a),
                 static_cast<const __nv_bfloat16*>(b),
                 static_cast<float*>(out), uvp, bc, reps);
      break;
    case 1:
      e = launch(probe_dot_s8<false>, blocks, s, a, b8, o32, uvp, bc, reps);
      break;
    case 2:
      e = launch(probe_dot_s8<true>, blocks, s, a, b8, o32, uvp, bc, reps);
      break;
    default:
      return -1;
  }
  return static_cast<int>(e);
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
