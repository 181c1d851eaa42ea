// GroupNorm for Hopper (sm_90a) with the elementwise work around it folded
// in: y = act(x' * A + B) over channels-last (N frames, HW pixels, C) input,
// where x' = x + pre[n, c] (an optional per-(frame, channel) pre-add), and
// A, B fold in the group's mean and 1/std, the weight and bias, and an
// optional per-(frame, channel) scale and shift (ADM's "* (1 + scale) +
// shift"). act is none or SiLU. Statistics are joint over the T frames of
// each of the B = N / T clips. Plain C interface, loaded with ctypes by
// flair_tpu_torch/ops/norms.py::group_norm_act.
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it on the TPU. In PyTorch the plain composition (ops/norms.py) runs
// about ten passes a norm: a cast to float32, var_mean, four float32
// broadcast passes, a cast back, then the callers' pre-add, scale-shift and
// SiLU, 24-27 times the activation's bytes.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. For an activation of S
// bytes it reads x twice (statistics, then the apply pass) and writes y
// once: 3 S (bf16 in and out; a float32 output writes 2 S). At x8's largest
// norm, 10 frames of 512² x 192 channels in bf16 (S = 1.0 GB), that is
// 0.90 ms.
//
// Design: three launches on the caller's stream, no host sync, no
// allocation (the wrapper passes one float32 workspace).
// 1. group_norm_stats, grid (K chunks, N frames): each block reduces one
//    chunk of one frame's pixels. A block is R rows x C / 8 columns of
//    threads (C <= 2048, so R >= 1); a thread owns 8 channels (one 16-byte
//    load of bf16, two of float32) of every R-th pixel, so a warp reads
//    whole pixel rows. Sums run in float32 registers on data shifted by the
//    chunk's first pixel (per channel), so a group whose |mean| is many
//    times its std loses no digits to cancellation. The rows are summed in
//    shared memory and the block writes each channel's chunk mean and sum of
//    squared deviations (M2).
// 2. group_norm_finalize, grid (G groups, B clips): merges the T x K x C/G
//    (count, mean, M2) partials of a group in float64, as sums of counts,
//    of count x (mean - m0) and of M2 + count x (mean - m0)^2 around the
//    group's first partial mean m0 (the pre-add shifts each channel's mean
//    and leaves its M2), then writes A and B for each (frame, channel) of
//    the group.
// 3. group_norm_apply, grid (blocks a frame, N frames): the same thread
//    layout as the statistics; each thread keeps its 8 channels' A and B in
//    registers and walks the frame's pixels, four 16-byte loads in flight:
//    one FMA, the optional SiLU and one rounding per element.
// The plain version rounds to the activation's dtype after the pre-add and
// between the norm, the scale-shift and the SiLU; this kernel does not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads a block at most
constexpr int VEC = 8;        // channels a thread handles per pixel
constexpr int UNROLL = 4;     // pixels in flight a thread

constexpr int MAX_C = THREADS * VEC;  // widest norm: one vector a thread

// A block is rows x v threads: v = C / 8 channel vectors side by side, rows
// pixels deep. The host reads rows through group_norm_rows.
struct Layout {
  int v, rows;
};

__host__ __device__ inline Layout layout(int C) {
  Layout l;
  l.v = C / VEC;
  l.rows = THREADS / l.v;
  return l;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[VEC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[VEC]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(f[0], f[1], f[2], f[3]);
  q[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
group_norm_stats(const T* __restrict__ x, int HW, int C, int chunk,
                 float* __restrict__ part_mean, float* __restrict__ part_m2) {
  __shared__ float s_sum[THREADS * VEC];
  __shared__ float s_sq[THREADS * VEC];
  __shared__ float s_shift[MAX_C];
  const Layout l = layout(C);
  const int tid = threadIdx.x;
  const int r = tid / l.v, v = tid % l.v;
  const int k = blockIdx.x, n = blockIdx.y;
  const int p0 = k * chunk;
  const int p1 = min(HW, p0 + chunk);
  const float cnt = static_cast<float>(p1 - p0);
  const T* frame = x + static_cast<size_t>(n) * HW * C;
  const size_t step = static_cast<size_t>(l.rows) * C;
  const size_t out = (static_cast<size_t>(n) * gridDim.x + k) * C;
  float sum[VEC], sq[VEC], shift[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sum[j] = sq[j] = 0.f;
  const T* p = frame + static_cast<size_t>(p0) * C + v * VEC;
  load8(p, shift);  // the chunk's first pixel, shared by every row
  p += static_cast<size_t>(r) * C;
  int i = p0 + r;
  for (; i + (UNROLL - 1) * l.rows < p1; i += UNROLL * l.rows) {
    float f[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load8(p + u * step, f[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = f[u][j] - shift[j];
        sum[j] += d;
        sq[j] = fmaf(d, d, sq[j]);
      }
    p += UNROLL * step;
  }
  for (; i < p1; i += l.rows) {
    float f[VEC];
    load8(p, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = f[j] - shift[j];
      sum[j] += d;
      sq[j] = fmaf(d, d, sq[j]);
    }
    p += step;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {  // [row][channel]
    s_sum[tid * VEC + j] = sum[j];
    s_sq[tid * VEC + j] = sq[j];
  }
  if (r == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) s_shift[v * VEC + j] = shift[j];
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int rr = 0; rr < l.rows; ++rr) {
      a += s_sum[rr * C + c];
      b += s_sq[rr * C + c];
    }
    const float m = a / cnt;
    part_mean[out + c] = s_shift[c] + m;
    part_m2[out + c] = fmaxf(b - a * m, 0.f);
  }
}

// A per-(frame, channel) tensor: element (n, c) at ptr[n * stride + c].
struct Aux {
  const void* ptr;
  long long stride;
  int bf16;
};

__device__ __forceinline__ double aux_at(const Aux& a, int n, int c) {
  const long long i = n * a.stride + c;
  return a.bf16 ? static_cast<double>(__bfloat162float(
                      static_cast<const __nv_bfloat16*>(a.ptr)[i]))
                : static_cast<double>(static_cast<const float*>(a.ptr)[i]);
}

__global__ void __launch_bounds__(THREADS)
group_norm_finalize(const float* __restrict__ part_mean,
                    const float* __restrict__ part_m2, int T, int HW, int C,
                    int G, int K, int chunk, const float* __restrict__ gamma,
                    const float* __restrict__ beta, Aux pre, Aux scale,
                    Aux shift, float eps, float* __restrict__ coef_a,
                    float* __restrict__ coef_b) {
  __shared__ double s_0[THREADS], s_1[THREADS], s_2[THREADS];
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int cg = C / G;
  const int items = T * K * cg;
  const int n0 = b * T, c0 = g * cg;
  double m0 = part_mean[static_cast<size_t>(n0) * K * C + c0];
  if (pre.ptr) m0 += aux_at(pre, n0, c0);
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  for (int i = tid; i < items; i += THREADS) {
    const int j = i % cg, kt = i / cg;
    const int k = kt % K, t = kt / K;
    const int n = b * T + t, c = g * cg + j;
    const size_t at = (static_cast<size_t>(n) * K + k) * C + c;
    double d = part_mean[at] - m0;
    if (pre.ptr) d += aux_at(pre, n, c);
    const double cnt = static_cast<double>(min(chunk, HW - k * chunk));
    a0 += cnt;
    a1 = fma(cnt, d, a1);
    a2 += fma(cnt * d, d, static_cast<double>(part_m2[at]));
  }
  s_0[tid] = a0;
  s_1[tid] = a1;
  s_2[tid] = a2;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      s_0[tid] += s_0[tid + s];
      s_1[tid] += s_1[tid + s];
      s_2[tid] += s_2[tid + s];
    }
    __syncthreads();
  }
  const double dm = s_1[0] / s_0[0];
  const double mu = m0 + dm;
  const double var = fmax(s_2[0] / s_0[0] - dm * dm, 0.0);
  const double rstd = rsqrt(var + static_cast<double>(eps));
  for (int i = tid; i < T * cg; i += THREADS) {
    const int j = i % cg, t = i / cg;
    const int n = b * T + t, c = g * cg + j;
    double a = rstd * (gamma ? static_cast<double>(gamma[c]) : 1.0);
    double bb = (beta ? static_cast<double>(beta[c]) : 0.0) - mu * a;
    if (scale.ptr) {
      const double s1 = 1.0 + aux_at(scale, n, c);
      a *= s1;
      bb *= s1;
    }
    if (shift.ptr) bb += aux_at(shift, n, c);
    if (pre.ptr) bb += aux_at(pre, n, c) * a;
    coef_a[static_cast<size_t>(n) * C + c] = static_cast<float>(a);
    coef_b[static_cast<size_t>(n) * C + c] = static_cast<float>(bb);
  }
}

template <bool SILU>
__device__ __forceinline__ float activate(float v) {
  return SILU ? v / (1.f + __expf(-v)) : v;
}

template <typename TI, typename TO, bool SILU>
__global__ void __launch_bounds__(THREADS)
group_norm_apply(const TI* __restrict__ x, TO* __restrict__ y,
                 const float* __restrict__ coef_a,
                 const float* __restrict__ coef_b, int HW, int C) {
  const Layout l = layout(C);
  const int tid = threadIdx.x;
  const int r = tid / l.v, v = tid % l.v, n = blockIdx.y;
  const size_t base = static_cast<size_t>(n) * HW * C;
  const int pstep = gridDim.x * l.rows;
  const size_t step = static_cast<size_t>(pstep) * C;
  float a[VEC], b[VEC];
  load8(coef_a + static_cast<size_t>(n) * C + v * VEC, a);
  load8(coef_b + static_cast<size_t>(n) * C + v * VEC, b);
  int i = blockIdx.x * l.rows + r;
  const TI* px = x + base + static_cast<size_t>(i) * C + v * VEC;
  TO* py = y + base + static_cast<size_t>(i) * C + v * VEC;
  for (; i + (UNROLL - 1) * pstep < HW; i += UNROLL * pstep) {
    float f[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load8(px + u * step, f[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        f[u][j] = activate<SILU>(fmaf(f[u][j], a[j], b[j]));
      store8(py + u * step, f[u]);
    }
    px += UNROLL * step;
    py += UNROLL * step;
  }
  for (; i < HW; i += pstep) {
    float f[VEC];
    load8(px, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      f[j] = activate<SILU>(fmaf(f[j], a[j], b[j]));
    store8(py, f);
    px += step;
    py += step;
  }
}

template <typename TI, typename TO>
void launch_apply(int silu, dim3 grid, dim3 block, cudaStream_t st,
                  const void* x, void* y, const float* coef_a,
                  const float* coef_b, int HW, int C) {
  const TI* xi = static_cast<const TI*>(x);
  TO* yo = static_cast<TO*>(y);
  if (silu)
    group_norm_apply<TI, TO, true><<<grid, block, 0, st>>>(xi, yo, coef_a,
                                                           coef_b, HW, C);
  else
    group_norm_apply<TI, TO, false><<<grid, block, 0, st>>>(xi, yo, coef_a,
                                                            coef_b, HW, C);
}

}  // namespace

extern "C" {

// Pixel rows of a block for C channels (the host sizes its grids by it), or
// -1 for a width the kernels do not take: C % 8 != 0 or C > 2048.
int group_norm_rows(int C) {
  return C <= 0 || C % VEC || C > MAX_C ? -1 : layout(C).rows;
}

// Launches the three kernels on `stream` and returns the first launch's
// CUDA error code (0 = launched), or -1 for a shape the kernels do not take.
// x and y are (N, HW, C) contiguous and 16-byte aligned: bf16 in and bf16
// or float32 out, or float32 in and out (in_bf16, out_bf16). N = B * T
// frames, statistics joint over each clip's T frames. ws holds
// 2 * N * K * C + 2 * N * C floats: the statistics kernel's K chunks a
// frame of `chunk` pixels (the last may be shorter), then A and B. The
// apply kernel runs KA blocks a frame. gamma and beta are float32 (C,) or
// null; pre, scale and shift are (N, C) with unit channel stride and the
// given row stride, bf16 or float32, or null.
int group_norm_forward(int in_bf16, int out_bf16, int silu, const void* x,
                       void* y, float* ws, int N, int T, int HW, int C, int G,
                       int K, int chunk, int KA, const float* gamma,
                       const float* beta, const void* pre,
                       long long pre_stride, int pre_bf16, const void* scale,
                       long long scale_stride, int scale_bf16,
                       const void* shift, long long shift_stride,
                       int shift_bf16, float eps, void* stream) {
  if (group_norm_rows(C) < 0 || (out_bf16 && !in_bf16) || G <= 0 ||
      C % G || T <= 0 || N % T || HW <= 0 || K <= 0 || chunk <= 0 ||
      static_cast<long long>(K) * chunk < HW ||
      static_cast<long long>(K - 1) * chunk >= HW || KA <= 0 || N > 65535 ||
      N / T > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout l = layout(C);
  const dim3 block(l.rows * l.v);
  float* part_mean = ws;
  float* part_m2 = part_mean + static_cast<size_t>(N) * K * C;
  float* coef_a = part_m2 + static_cast<size_t>(N) * K * C;
  float* coef_b = coef_a + static_cast<size_t>(N) * C;
  if (in_bf16)
    group_norm_stats<__nv_bfloat16><<<dim3(K, N), block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), HW, C, chunk, part_mean,
        part_m2);
  else
    group_norm_stats<float><<<dim3(K, N), block, 0, st>>>(
        static_cast<const float*>(x), HW, C, chunk, part_mean, part_m2);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  group_norm_finalize<<<dim3(G, N / T), THREADS, 0, st>>>(
      part_mean, part_m2, T, HW, C, G, K, chunk, gamma, beta,
      Aux{pre, pre_stride, pre_bf16}, Aux{scale, scale_stride, scale_bf16},
      Aux{shift, shift_stride, shift_bf16}, eps, coef_a, coef_b);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(KA, N);
  if (in_bf16 && out_bf16)
    launch_apply<__nv_bfloat16, __nv_bfloat16>(silu, grid, block, st, x, y,
                                               coef_a, coef_b, HW, C);
  else if (in_bf16)
    launch_apply<__nv_bfloat16, float>(silu, grid, block, st, x, y, coef_a,
                                       coef_b, HW, C);
  else
    launch_apply<float, float>(silu, grid, block, st, x, y, coef_a, coef_b,
                               HW, C);
  return static_cast<int>(cudaGetLastError());
}

const char* group_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
