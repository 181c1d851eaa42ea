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
//   0  bf16 x bf16 -> f32    wgmma m64n128k16 .f32.bf16.bf16
//   1  s8 x s8 -> s32        wgmma m64n128k32 .s32.s8.s8
//   2  f32 a, quantised every rep (a * 127 rounded half to even as
//      jnp.round, by adding 1.5 * 2^23) x s8 b -> s32, the s8 wgmma
// Every one of the REPS x UVP products is issued: nothing is summed over r
// first (the TPU probe's note :83-86: work hoisted out of the REPS loop is
// not measured), and variant 2 quantises a[g]'s slice again for every r, as
// the TPU kernel reads a_ref[0] and rounds it inside its REPS loop.
//
// What bounds it: 2 * REPS * GRID * UVP * BC * 128 = 1.24e12 operations at
// UVP 256 against 989e12 (bf16) / 1979e12 (int8) a second: 1.25 / 0.63 ms,
// far above the bytes (a, b and out once: 0.6 GB bf16, 0.18 ms).
//
// Design. A block owns one grid step g and BM rows of BC: three consumer
// warpgroups of 64 rows (BM 192; variant 2: one, BM 64, and two quantiser
// warpgroups) and one producer warpgroup, whose one thread feeds b by TMA.
// setmaxnreg moves the producer's registers to the others.
// - a[g]'s slice is loaded into shared memory once per block and read there
//   by every rep, as the TPU kernel keeps a[g] in VMEM for its grid step:
//   bf16 by TMA in its own (K, M) layout, 128-byte swizzled, which wgmma
//   reads MN-major (the descriptor's transpose bit); s8 transposed once by
//   the consumers into the K-major 128-byte-swizzled layout (wgmma takes
//   8-bit operands K-major only). Variant 2's f32 slice (64 x UVP) comes by
//   TMA into the space of its quantised copies, and from there into the
//   quantisers' registers (up to 96 floats a thread); each rep they
//   round it into one of QBUFS K-major s8 buffers, up to QBUFS - 1 reps
//   ahead of the consumer's wgmma, the buffers passed back and forth by
//   mbarriers.
// - b streams through a ring of STAGES 16 KB tiles (8 quantised, else 4), each
//   guarded by a full and an empty mbarrier. bf16 tiles come in b's own
//   (K, N) layout (MN-major); s8 tiles from b transposed to (REPS, 128, K)
//   by a small pre-pass kernel in the same call (wgmma's K-major), its K
//   padded with zeros to whole 128-byte rows. (Clusters of 2 or 4 grid
//   steps sharing each tile by TMA multicast were no faster on the H100:
//   PERF.md.)
// - Consumers keep their 64 x 128 sums in registers across all REPS x UVP
//   of K (64 a thread), issue one wgmma group a stage, keep one group in
//   flight, and write f32 / s32 straight from the accumulators.
// Shared memory: the ring (128 KB quantised, else 64 KB) + a: 3 * UVP *
// 128 bytes (bf16), 3 * 64 * K' (s8; K' = UVP rounded up to 128) or QBUFS
// * 64 * K' (variant 2): at most 225 KB, variant 2 at UVP 384. The kernel
// takes 64 <= UVP <= 384, UVP % 64 == 0, BC % BM == 0 (the wrapper checks).

#include <cuda.h>  // CUtensorMap and its enums (the encoder: the runtime's)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum { BF16 = 0, S8 = 1, QUANT = 2 };

constexpr int BN = 128;              // output columns: all 128 lanes
constexpr int STAGE_BYTES = 16384;   // 64 bf16 K x 128, or 128 s8 K x 128
constexpr int ATOM_ROWS_BYTES = 8192;  // 64 rows x one 128-byte K row (s8)
constexpr int MAX_UVP = 384;

template <int V>
struct Cfg {
  static constexpr int NWG = V == QUANT ? 1 : 3;  // consumer warpgroups
  static constexpr int NQ = V == QUANT ? 2 : 0;   // quantiser warpgroups
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + NQ + 1);
  // b tiles in flight (the fastest depths on the H100: PERF.md)
  static constexpr int STAGES = V == QUANT ? 8 : 4;
};

// variant 2's quantised copies of a in flight: the quantisers run up to
// QBUFS - 1 reps ahead of the consumer; their space first holds the f32
// slice (256 bytes a K row against QBUFS * 64)
constexpr int QBUFS = 4;
static_assert(QBUFS * 64 >= 256, "the f32 slice must fit the quantised copies");

__host__ __device__ constexpr int kpad(int uvp) {
  return (uvp + 127) / 128 * 128;
}

// bytes of a's on-chip copy (see the header)
template <int V>
__host__ __device__ constexpr int a_bytes(int uvp) {
  return V == BF16 ? 3 * uvp * 128
         : V == S8 ? 3 * 64 * kpad(uvp)
                   : QBUFS * 64 * kpad(uvp);
}

// dynamic shared memory: 1 KB of alignment slack, the ring, a, the mbarriers
template <int V>
__host__ __device__ constexpr int smem_bytes(int uvp) {
  return 1024 + Cfg<V>::STAGES * STAGE_BYTES + a_bytes<V>(uvp) + 256;
}

// ---- PTX helpers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A pipeline
// fault traps after about 20 s of waiting instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      t0 = clock64();
    } else if ((spin & 1023) == 0 && clock64() - t0 > (1LL << 35)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// the consumer warpgroup's own barrier (id 1 + warpgroup; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// threads' shared-memory writes, before wgmma (async proxy) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// TMA tile loads into shared memory, completing bytes on the barrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define WG_D8(T, o)                                                        \
  T(d[o]), T(d[o + 1]), T(d[o + 2]), T(d[o + 3]), T(d[o + 4]), T(d[o + 5]), \
      T(d[o + 6]), T(d[o + 7])
#define WG_D64(T)                                                        \
  WG_D8(T, 0), WG_D8(T, 8), WG_D8(T, 16), WG_D8(T, 24), WG_D8(T, 32),    \
      WG_D8(T, 40), WG_D8(T, 48), WG_D8(T, 56)
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)
#define WG_LIST                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d += A (64 x 16, MN-major) . B (16 x 128, MN-major), bf16 -> f32
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_LIST
      ", %64, %65, p, 1, 1, 1, 1;\n\t}"
      : WG_D64(WG_F)
      : "l"(da), "l"(db), "r"(1));
}

// d += A (64 x 32, K-major) . B (32 x 128, K-major), s8 -> s32
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_LIST
      ", %64, %65, p;\n\t}"
      : WG_D64(WG_R)
      : "l"(da), "l"(db), "r"(1));
}

// round(v * 127) to s8, half to even, in the low byte of the result:
// v * 127 (mul.rn, as the plain version rounds it) plus 1.5 * 2^23
// (add.rn) leaves the rounded integer in the float's low mantissa bits,
// exact for |v * 127| < 2^22; a in [0, 1] needs no saturation. Two FP32
// operations instead of cvt.rni.sat.s8.f32, 1.4x slower on the H100
// (PERF.md). volatile: v does not change across the REPS loop, so plain
// arithmetic would be hoisted out of it; each rep must round again
// (chip_smoke.py's kernel_probe checks the machine code for it).
__device__ __forceinline__ uint32_t quant_s8(float v) {
  uint32_t q;
  asm volatile(
      "{\n\t.reg .f32 t;\n\tmul.rn.f32 t, %1, 0f42FE0000;\n\t"  // 127
      "add.rn.f32 t, t, 0f4B400000;\n\tmov.b32 %0, t;\n\t}"       // 1.5 * 2^23
      : "=r"(q)
      : "f"(v));
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

// byte offset of row `row`'s 16-byte K chunk `c` (of K-atom `ka`) in a
// K-major, 128-byte-swizzled 64-row operand: the layout TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and the descriptor reads
__device__ __forceinline__ int kmajor_off(int ka, int row, int c) {
  return ka * ATOM_ROWS_BYTES + row * 128 + ((c ^ (row & 7)) << 4);
}

// Variant 1: the consumer warpgroup's 64 rows of a[g] (s8, (K, M) in global)
// into its K-major copy, zeros past UVP. A unit is 16 K-rows x 4 rows of M:
// sixteen 32-bit loads along M, four 4 x 4 byte transposes, four 16-byte
// stores.
__device__ __forceinline__ void stage_a_s8(const int8_t* __restrict__ ag,
                                           uint8_t* dst, int uvp, int bc,
                                           int t) {
  const int units = kpad(uvp) / 16 * 16;
  for (int u = t; u < units; u += 128) {
    const int kg = u / 16, mq = u % 16;
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = kg * 16 + i;
      w[i] = k < uvp ? __ldg(reinterpret_cast<const uint32_t*>(
                           ag + static_cast<long long>(k) * bc + 4 * mq))
                     : 0u;
    }
    uint32_t rows[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t tr[4];
      transpose4x4(w + 4 * q, tr);
#pragma unroll
      for (int j = 0; j < 4; ++j) rows[j][q] = tr[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint4*>(dst + kmajor_off(kg / 8, 4 * mq + j, kg % 8)) =
          make_uint4(rows[j][0], rows[j][1], rows[j][2], rows[j][3]);
  }
}

// ---- the kernel ------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(Cfg<V>::THREADS, 1)
    probe_dot_wgmma(const __grid_constant__ CUtensorMap tm_a,  // variants 0, 2
                    const __grid_constant__ CUtensorMap tm_b,
                    const void* __restrict__ a, void* __restrict__ out, int uvp,
                    int bc, int reps) {
  constexpr int NWG = Cfg<V>::NWG, NQ = Cfg<V>::NQ, BM = Cfg<V>::BM,
                STAGES = Cfg<V>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* abuf = smem + STAGES * STAGE_BYTES;
  // barriers: full[STAGES], empty[STAGES], afull (a's slice: variants 0
  // and 2), qfull[QBUFS] and qempty[QBUFS] (variant 2: the quantised
  // buffers)
  const uint32_t full0 = smem_addr(abuf + a_bytes<V>(uvp)),
                 empty0 = full0 + 8 * STAGES, afull = full0 + 16 * STAGES,
                 qfull0 = afull + 8, qempty0 = qfull0 + 8 * QBUFS;
  const int tid = threadIdx.x, wg = tid / 128;
  const int g = blockIdx.y, m0 = blockIdx.x * BM;
  // K tiles a rep: 64 bf16 rows, or one 128-byte s8 K row (zero padded)
  const int nkt = V == BF16 ? uvp / 64 : kpad(uvp) / 128;
  const int qbytes = 64 * kpad(uvp);  // one quantised buffer (variant 2)

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NWG);  // every consumer warp
    }
    mbar_init(afull, 1);
    for (int i = 0; i < QBUFS; ++i) {
      mbar_init(qfull0 + 8 * i, 128 * NQ);  // every quantiser thread
      mbar_init(qempty0 + 8 * i, 4);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG + NQ) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid % 128 == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_b))
                   : "memory");
      if constexpr (V == BF16) {
        // a[g]'s slice, once: 64 x 64 boxes, warpgroup w's rows k at
        // abuf + w * uvp * 128 + k * 128
        mbar_expect_tx(afull, a_bytes<V>(uvp));
        for (int w = 0; w < 3; ++w)
          for (int kb = 0; kb < uvp / 64; ++kb)
            tma_load_3d(smem_addr(abuf + w * uvp * 128 + kb * 8192), &tm_a,
                        afull, m0 + 64 * w, kb * 64, g);
      } else if constexpr (V == QUANT) {
        // the f32 slice, once, rows k of 64 floats at abuf + k * 256 (the
        // quantised buffers' space, free until the quantisers have read it)
        mbar_expect_tx(afull, uvp * 256);
        for (int kb = 0; kb < uvp / 64; ++kb)
          tma_load_3d(smem_addr(abuf + kb * 16384), &tm_a, afull, m0, kb * 64,
                      g);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int r = 0; r < reps; ++r)
        for (int kt = 0; kt < nkt; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, STAGE_BYTES);
          const uint32_t dst = smem_addr(ring + stage * STAGE_BYTES);
          if constexpr (V == BF16) {
            // two 64-column halves of 64 K rows, 8 KB each
            for (int half = 0; half < 2; ++half)
              tma_load_2d(dst + half * 8192, &tm_b, full, half * 64,
                          r * uvp + kt * 64);
          } else {
            // 128 rows of n, 128 K bytes each
            tma_load_2d(dst, &tm_b, full, kt * 128, r * 128);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else if (wg >= NWG) {
    // ---- variant 2's quantisers: the f32 slice lives in their registers,
    // thread (row, part) holding the 16-K chunks c = part, part + 4, ...;
    // each rep they round it into buffer r % QBUFS once the consumer has
    // released that buffer's rep r - QBUFS ----
    if constexpr (NQ > 0) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
      constexpr int QJ = MAX_UVP / 16 / 4;  // chunks a thread at most
      const int qt = tid - 128 * NWG, row = qt % 64, part = qt / 64;
      const int nch = kpad(uvp) / 16;
      const float* f32s = reinterpret_cast<const float*>(abuf) + row;
      float v[QJ][16];
      mbar_wait(afull, 0);
#pragma unroll
      for (int j = 0; j < QJ; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int k = 16 * (part + 4 * j) + i;  // rows past UVP read as 0
          v[j][i] = k < uvp ? f32s[k * 64] : 0.f;
        }
      // every quantiser has its values before rep 0 overwrites the slice
      asm volatile("bar.sync 1, %0;" ::"n"(128 * NQ) : "memory");
      for (int r = 0; r < reps; ++r) {
        const int buf = r % QBUFS;
        if (r >= QBUFS)
          mbar_wait(qempty0 + 8 * buf, ((r - QBUFS) / QBUFS) & 1);
        uint8_t* q = abuf + buf * qbytes;
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          const int c = part + 4 * j;
          if (c < nch) {
            uint32_t wd[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              wd[i] = pack4(
                  quant_s8(v[j][4 * i]), quant_s8(v[j][4 * i + 1]),
                  quant_s8(v[j][4 * i + 2]), quant_s8(v[j][4 * i + 3]));
            *reinterpret_cast<uint4*>(q + kmajor_off(c / 8, row, c % 8)) =
                make_uint4(wd[0], wd[1], wd[2], wd[3]);
          }
        }
        fence_proxy_async();
        mbar_arrive(qfull0 + 8 * buf);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns output rows m0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;");
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int rows0 = m0 + 64 * wg;
    using Acc = typename std::conditional<V == BF16, float, int>::type;
    Acc d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;

    uint8_t* aw = abuf + wg * (V == BF16 ? uvp * 128 : qbytes);
    if constexpr (V == BF16) {
      mbar_wait(afull, 0);
    } else if constexpr (V == S8) {
      stage_a_s8(static_cast<const int8_t*>(a) +
                     static_cast<long long>(g) * uvp * bc + rows0,
                 aw, uvp, bc, t);
      fence_proxy_async();
      wg_sync(wg);
    }

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int r = 0; r < reps; ++r) {
      const uint8_t* ar = aw;
      if constexpr (V == QUANT) {
        mbar_wait(qfull0 + 8 * (r % QBUFS), (r / QBUFS) & 1);
        ar = abuf + (r % QBUFS) * qbytes;
      }
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t bs = smem_addr(ring + stage * STAGE_BYTES);
        wgmma_fence();
        if constexpr (V == BF16) {
          // A: rows k of 64 m (128 B), 8-row groups 1 KB apart; B: two
          // 64-column halves 8 KB apart, the same rows
          const uint32_t as = smem_addr(ar) + kt * 64 * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16(d, sw128_desc(as + kk * 2048, 8192, 1024),
                       sw128_desc(bs + kk * 2048, 8192, 1024));
        } else {
          // A and B: 128-byte K rows, 8-row groups 1 KB apart; k32 steps
          // 32 bytes along the row
          const uint32_t as = smem_addr(ar) + kt * ATOM_ROWS_BYTES;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_s8(d, sw128_desc(as + kk * 32, 16, 1024),
                     sw128_desc(bs + kk * 32, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group has retired
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        // variant 2: so has every group of rep r - 1; its buffer is free
        if constexpr (V == QUANT) {
          if (kt == 0 && r > 0 && lane == 0)
            mbar_arrive(qempty0 + 8 * ((r - 1) % QBUFS));
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // d[i]: row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
    // 2 (lane % 4) + i % 2
    Acc* og = static_cast<Acc*>(out) +
              (static_cast<long long>(g) * bc + rows0 + 16 * warp + lane / 4) *
                  BN +
              2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      using Acc2 = typename std::conditional<V == BF16, float2, int2>::type;
      *reinterpret_cast<Acc2*>(og + 8 * j) = Acc2{d[4 * j], d[4 * j + 1]};
      *reinterpret_cast<Acc2*>(og + 8 * BN + 8 * j) =
          Acc2{d[4 * j + 2], d[4 * j + 3]};
    }
  }
}

// b (REPS, UVP, 128) s8 -> bt (REPS, 128, kp), zeros past UVP: wgmma's
// K-major B. A block moves 64 K rows of one rep through a padded tile.
__global__ void __launch_bounds__(256)
    transpose_b(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int uvp,
                int kp) {
  constexpr int PITCH = 132;  // bytes a K row of the tile: conflict-light reads
  __shared__ __align__(16) uint8_t tile[64 * PITCH];
  const int r = blockIdx.y, k0 = blockIdx.x * 64, tid = threadIdx.x;
  for (int i = tid; i < 64 * 32; i += 256) {
    const int k = i / 32, n4 = i % 32;
    *reinterpret_cast<uint32_t*>(tile + k * PITCH + 4 * n4) =
        k0 + k < uvp ? __ldg(reinterpret_cast<const uint32_t*>(
                           b + (static_cast<long long>(r) * uvp + k0 + k) * BN +
                           4 * n4))
                     : 0u;
  }
  __syncthreads();
  for (int i = tid; i < BN * 16; i += 256) {
    const int n = i / 16, kw = i % 16;
    const uint8_t* s = tile + 4 * kw * PITCH + n;
    *reinterpret_cast<uint32_t*>(
        bt + (static_cast<long long>(r) * BN + n) * kp + k0 + 4 * kw) =
        pack4(s[0], s[PITCH], s[2 * PITCH], s[3 * PITCH]);
  }
}

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// codes of this file's own failures (CUDA's errors are positive)
constexpr int ERR_VARIANT = -1, ERR_ENCODER = -2, ERR_TENSOR_MAP = -3,
              ERR_SHAPE = -4;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled map of a dense row-major tensor, 128-byte swizzled unless
// `swizzle` is false: dims and box innermost first, strides in bytes of
// every dim but the innermost.
int encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* p,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box, bool swizzle = true) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_ENCODER;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(p), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <int V>
cudaError_t launch_main(const CUtensorMap& ta, const CUtensorMap& tb,
                        const void* a, void* out, int grid, int uvp, int bc,
                        int reps, cudaStream_t s) {
  auto kernel = probe_dot_wgmma<V>;
  const int smem = smem_bytes<V>(uvp);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(bc / Cfg<V>::BM, grid), Cfg<V>::THREADS, smem, s>>>(
      ta, tb, a, out, uvp, bc, reps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one probe on `stream`: variant 0 (a, b bf16; out f32), 1 (a, b
// int8; out int32), 2 (a f32 in [0, 1], quantised; b int8; out int32).
// a (grid, uvp, bc), b (reps, uvp, 128), out (grid, bc, 128), contiguous
// and 16-byte aligned; bt: scratch of reps * 128 * K' bytes (K' = uvp
// rounded up to 128) for the s8 variants, which first launch the b
// transpose into it. Needs 64 <= uvp <= 384, uvp % 64 == 0, bc % 192 == 0
// (variant 2: bc % 64 == 0), grid <= 65535 (the wrapper checks). Returns
// 0, a CUDA error code, or a negative code (probe_error_string).
int probe_dot(int variant, const void* a, const void* b, void* out, void* bt,
              int grid, int uvp, int bc, int reps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bm = variant == QUANT ? Cfg<QUANT>::BM : Cfg<BF16>::BM;
  if (variant < 0 || variant > 2) return ERR_VARIANT;
  if (uvp < 64 || uvp > MAX_UVP || uvp % 64 || bc % bm || bc < bm || grid < 1 ||
      grid > 65535 || reps < 1)
    return ERR_SHAPE;
  CUtensorMap ta = {}, tb = {};
  int rc;
  if (variant == BF16) {
    const cuuint64_t adims[3] = {static_cast<cuuint64_t>(bc),
                                 static_cast<cuuint64_t>(uvp),
                                 static_cast<cuuint64_t>(grid)};
    const cuuint64_t astr[2] = {static_cast<cuuint64_t>(bc) * 2,
                                static_cast<cuuint64_t>(uvp) * bc * 2};
    const cuuint32_t abox[3] = {64, 64, 1};
    rc = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a, adims, astr, abox);
    if (rc) return rc;
    const cuuint64_t bdims[2] = {BN, static_cast<cuuint64_t>(reps) * uvp};
    const cuuint64_t bstr[1] = {BN * 2};
    const cuuint32_t bbox[2] = {64, 64};
    rc = encode(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, bdims, bstr, bbox);
    if (rc) return rc;
    return launch_main<BF16>(ta, tb, a, out, grid, uvp, bc, reps, s);
  }
  const int kp = kpad(uvp);
  transpose_b<<<dim3(kp / 64, reps), 256, 0, s>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), uvp, kp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const cuuint64_t bdims[2] = {static_cast<cuuint64_t>(kp),
                               static_cast<cuuint64_t>(reps) * BN};
  const cuuint64_t bstr[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t bbox[2] = {128, 128};
  rc = encode(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, bt, bdims, bstr, bbox);
  if (rc) return rc;
  if (variant == QUANT) {
    const cuuint64_t adims[3] = {static_cast<cuuint64_t>(bc),
                                 static_cast<cuuint64_t>(uvp),
                                 static_cast<cuuint64_t>(grid)};
    const cuuint64_t astr[2] = {static_cast<cuuint64_t>(bc) * 4,
                                static_cast<cuuint64_t>(uvp) * bc * 4};
    const cuuint32_t abox[3] = {64, 64, 1};
    rc = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, a, adims, astr, abox,
                false);
    if (rc) return rc;
  }
  return variant == S8
             ? launch_main<S8>(ta, tb, a, out, grid, uvp, bc, reps, s)
             : launch_main<QUANT>(ta, tb, a, out, grid, uvp, bc, reps, s);
}

const char* probe_error_string(int code) {
  switch (code) {
    case ERR_VARIANT:
      return "unknown variant";
    case ERR_ENCODER:
      return "cuTensorMapEncodeTiled not found in the driver";
    case ERR_TENSOR_MAP:
      return "cuTensorMapEncodeTiled refused a map";
    case ERR_SHAPE:
      return "shape the kernel does not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
