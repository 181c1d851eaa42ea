// BasicVSR++'s per-frame glue for Hopper (sm_90a): the elementwise work
// around the cuDNN convolutions and K1 in one step of the recurrence
// (flair_tpu_torch/models/vsrpp.py::_run_branch), as three kernels. Plain C
// interface, loaded with ctypes by flair_tpu_torch/ops/vsrpp_step.py.
//
// Replaces no TPU kernel: the JAX package writes the step in plain jnp
// inside a lax.scan, which XLA fuses on the TPU. In PyTorch the same step
// ran as about 45 launches a frame, most of them bf16 bias adds onto
// channels-last conv outputs, cats, casts and a float32 grid_sample.
//
// 1. vsrpp_warp_pair: the two hidden states [n1 | n2] (one NHWC tensor of
//    2C channels) warped by their flows (bilinear, zero padding,
//    align_corners=True, coordinates and weights in float32, exactly as
//    ops/warp.py::flow_warp computes them on the card) into one NHWC tensor
//    of 2C channels, the input of the offset branch's first conv.
// 2. vsrpp_bias_act: y = act(x + bias + addend) after a conv, in float32
//    with one rounding on store; act is none, LeakyReLU(0.1) or ReLU.
// 3. vsrpp_gate_tail: the end of a step, v = (prop + (r + (y + bias))) * g
//    with g a per-frame scalar or a per-pixel gate, stored into the output's
//    frame slot and into the next step's pair [v | n1].
//
// What bounds them on an H100 SXM (3.35 TB/s): bytes. Each element is read
// once and written once (the warp reads each corner's 16-byte vector, and
// the four corners of neighbouring pixels meet in L1 / L2). At 512², C = 64,
// bf16 a plane of one frame is 33.5 MB: the warp moves 4 planes, the bias
// passes 2-3 (13.5 after the 27·G-channel offset conv), the tail 7.
//
// Design: one thread per (frame, pixel, 8-channel vector), 16-byte loads and
// stores (two for float32), a 2-D grid (pixel vectors, frames), no shared
// memory, no host sync, no allocation. The bias pass also has a scalar
// instance, a channel a thread, for widths that are not whole vectors: the
// offset head's 27·G channels when G is not a multiple of 8. Biases, gates and flows are read a
// scalar at a time (cached), so they need no alignment: the benchmark's
// parameters are views at any offset of one buffer. Every activation
// tensor is NHWC per frame:
// element (b, pixel, c) at p[b * bs + pixel * ps + c], so channel slices of
// a wider tensor (the pair's halves, a frame of a clip) are views.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // channels a thread (but the scalar bias pass)

enum Act { ACT_NONE = 0, ACT_LEAKY = 1, ACT_RELU = 2 };

__device__ __forceinline__ void load(const __nv_bfloat16* p,
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

__device__ __forceinline__ void load(const float* p, float (&f)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store(__nv_bfloat16* p,
                                       const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store(float* p, const float (&f)[VEC]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(f[0], f[1], f[2], f[3]);
  q[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// One channel: the scalar bias pass.
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[1]) {
  f[0] = __bfloat162float(*p);
}

__device__ __forceinline__ void load(const float* p, float (&f)[1]) {
  f[0] = __ldg(p);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[1]) {
  *p = __float2bfloat16_rn(f[0]);
}

__device__ __forceinline__ void store(float* p, const float (&f)[1]) {
  *p = f[0];
}

// An 8-channel vector copied as stored (the pair's second half).
__device__ __forceinline__ void move8(const __nv_bfloat16* src,
                                      __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

__device__ __forceinline__ void move8(const float* src, float* dst) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = __ldg(s);
  d[1] = __ldg(s + 1);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_LEAKY) return v > 0.f ? v : v * 0.1f;
  if (ACT == ACT_RELU) return v < 0.f ? 0.f : v;
  return v;
}

// Source coordinate of a displaced pixel as flow_warp reaches it on the
// card: normalised by PyTorch's scalar division (a multiply by the float
// reciprocal) and back by grid_sample's align_corners=True unnormalise.
// The _rn intrinsics keep nvcc from contracting the steps into an FMA,
// which the separate PyTorch kernels do not.
__device__ __forceinline__ float source_coord(int i, float d, int size) {
  const float v = static_cast<float>(i) + d;
  const float inv = 1.f / static_cast<float>(max(size - 1, 1));
  const float n = __fadd_rn(__fmul_rn(2.f * v, inv), -1.f);
  return __fmul_rn(__fadd_rn(n, 1.f) * 0.5f, static_cast<float>(size - 1));
}

// grid (ceil(HW * 2C / 8 / THREADS), B): thread = (pixel, vector of the 2C
// channels); vectors [0, C/8) belong to n1 and take flow1, the rest n2 and
// flow2. Flows are (B, 2, H, W) float32 planes (dx, dy), frame stride fbs.
template <typename T>
__global__ void __launch_bounds__(THREADS)
vsrpp_warp_pair(const T* __restrict__ pair, long long pair_bs, int pair_ps,
                const float* __restrict__ flow1,
                const float* __restrict__ flow2, long long flow_bs,
                T* __restrict__ out, long long out_bs, int out_ps, int H,
                int W, int C) {
  const int v2 = 2 * (C / VEC);
  const int HW = H * W;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= HW * v2) return;
  const int b = blockIdx.y;
  const int v = idx % v2, pix = idx / v2;
  const int x = pix % W, y = pix / W;
  const float* f = (v < v2 / 2 ? flow1 : flow2) + b * flow_bs;
  const float ix = source_coord(x, __ldg(f + pix), W);
  const float iy = source_coord(y, __ldg(f + HW + pix), H);
  // grid_sample's bilinear corners and weights (GridSampler.cu), in order
  const int x0 = static_cast<int>(floorf(ix));
  const int y0 = static_cast<int>(floorf(iy));
  const int x1 = x0 + 1, y1 = y0 + 1;
  const float w_nw = (x1 - ix) * (y1 - iy);
  const float w_ne = (ix - x0) * (y1 - iy);
  const float w_sw = (x1 - ix) * (iy - y0);
  const float w_se = (ix - x0) * (iy - y0);
  const T* src = pair + b * pair_bs + v * VEC;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const int cx[4] = {x0, x1, x0, x1};
  const int cy[4] = {y0, y0, y1, y1};
  const float cw[4] = {w_nw, w_ne, w_sw, w_se};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cx[k] >= 0 && cx[k] < W && cy[k] >= 0 && cy[k] < H) {
      float t[VEC];
      load(src + static_cast<long long>(cy[k] * W + cx[k]) * pair_ps, t);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += t[j] * cw[k];
    }
  }
  store(out + b * out_bs + static_cast<long long>(pix) * out_ps + v * VEC,
         acc);
}

// grid (ceil(HW * C / V / THREADS), B): y = act(x + bias + add), bias
// float32 (C,) or null, add an NHWC view or null; V channels a thread.
template <typename T, int ACT, int V>
__global__ void __launch_bounds__(THREADS)
vsrpp_bias_act(const T* __restrict__ x, long long x_bs, int x_ps,
               const float* __restrict__ bias, const T* __restrict__ add,
               long long add_bs, int add_ps, T* __restrict__ y,
               long long y_bs, int y_ps, int HW, int C) {
  const int nv = C / V;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= HW * nv) return;
  const int b = blockIdx.y;
  const int c = (idx % nv) * V;
  const long long pix = idx / nv;
  float f[V];
  load(x + b * x_bs + pix * x_ps + c, f);
  if (bias) {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] += __ldg(bias + c + j);
  }
  if (add) {
    float t[V];
    load(add + b * add_bs + pix * add_ps + c, t);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] += t[j];
  }
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = activate<ACT>(f[j]);
  store(y + b * y_bs + pix * y_ps + c, f);
}

// grid (ceil(HW * C / 8 / THREADS), B): v = (prop + (r + (yc + bias))) * g,
// prop null at a branch's first frame (no aligned feature); g at
// gate[b * gbs + row * gsy + col * gsx] (gsy = gsx = 0: one per frame). v
// goes to out and to npair[:, :C]; pair[:, :C] (this step's n1) moves to
// npair[:, C:].
template <typename T>
__global__ void __launch_bounds__(THREADS)
vsrpp_gate_tail(const T* __restrict__ prop, long long prop_bs, int prop_ps,
                const T* __restrict__ r, long long r_bs, int r_ps,
                const T* __restrict__ yc, long long y_bs, int y_ps,
                const float* __restrict__ bias, const T* __restrict__ gate,
                long long gbs, long long gsy, long long gsx,
                const T* __restrict__ pair, long long pair_bs, int pair_ps,
                T* __restrict__ out, long long out_bs, int out_ps,
                T* __restrict__ npair, long long npair_bs, int npair_ps,
                int W, int HW, int C) {
  const int nv = C / VEC;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= HW * nv) return;
  const int b = blockIdx.y;
  const int c = (idx % nv) * VEC;
  const int p = idx / nv;
  const long long pix = p;
  const float g = to_float(gate[b * gbs + (p / W) * gsy + (p % W) * gsx]);
  float f[VEC], t[VEC];
  load(yc + b * y_bs + pix * y_ps + c, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] += __ldg(bias + c + j);
  load(r + b * r_bs + pix * r_ps + c, t);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = t[j] + f[j];
  if (prop) {
    load(prop + b * prop_bs + pix * prop_ps + c, t);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = t[j] + f[j];
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] *= g;
  store(out + b * out_bs + pix * out_ps + c, f);
  T* np = npair + b * npair_bs + pix * npair_ps + c;
  store(np, f);
  move8(pair + b * pair_bs + pix * pair_ps + c, np + C);
}

// The checks every entry point makes: whole vectors of `vec` channels, a
// grid the card takes.
bool shape_ok(int B, int HW, int C, int vec = VEC) {
  return B > 0 && B <= 65535 && HW > 0 && C > 0 && C % vec == 0 &&
         static_cast<long long>(HW) * 2 * (C / vec) < (1LL << 31) - THREADS;
}

dim3 grid_of(int HW, int vectors, int B) {
  return dim3((HW * vectors + THREADS - 1) / THREADS, B);
}

template <typename T, int V>
void launch_bias_act(int act, cudaStream_t st, const void* x, long long x_bs,
                     int x_ps, const float* bias, const void* add,
                     long long add_bs, int add_ps, void* y, long long y_bs,
                     int y_ps, int B, int HW, int C) {
  const dim3 grid = grid_of(HW, C / V, B);
  const T* xi = static_cast<const T*>(x);
  const T* ai = static_cast<const T*>(add);
  T* yo = static_cast<T*>(y);
  if (act == ACT_LEAKY)
    vsrpp_bias_act<T, ACT_LEAKY, V><<<grid, THREADS, 0, st>>>(
        xi, x_bs, x_ps, bias, ai, add_bs, add_ps, yo, y_bs, y_ps, HW, C);
  else if (act == ACT_RELU)
    vsrpp_bias_act<T, ACT_RELU, V><<<grid, THREADS, 0, st>>>(
        xi, x_bs, x_ps, bias, ai, add_bs, add_ps, yo, y_bs, y_ps, HW, C);
  else
    vsrpp_bias_act<T, ACT_NONE, V><<<grid, THREADS, 0, st>>>(
        xi, x_bs, x_ps, bias, ai, add_bs, add_ps, yo, y_bs, y_ps, HW, C);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns its CUDA
// error code (0 = launched), or -1 for a call it does not take. bf16 = 1:
// every activation tensor is bf16, else float32; flows and biases are
// float32. Strides are in elements; in the vector instances each view's
// pointer, frame stride and pixel stride keep its 8-channel vectors 16-byte
// aligned (the wrapper checks). Inputs must not overlap outputs.

// out (B, HW, 2C) = [warp(pair[..., :C], flow1) | warp(pair[..., C:], flow2)]
int vsrpp_warp_pair_launch(int bf16, const void* pair, long long pair_bs,
                           int pair_ps, const float* flow1,
                           const float* flow2, long long flow_bs, void* out,
                           long long out_bs, int out_ps, int B, int H, int W,
                           int C, void* stream) {
  if (!shape_ok(B, H * W, C) || H <= 0 || W <= 0 || pair_ps < 2 * C ||
      out_ps < 2 * C)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(H * W, 2 * (C / VEC), B);
  if (bf16)
    vsrpp_warp_pair<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(pair), pair_bs, pair_ps, flow1,
        flow2, flow_bs, static_cast<__nv_bfloat16*>(out), out_bs, out_ps, H,
        W, C);
  else
    vsrpp_warp_pair<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(pair), pair_bs, pair_ps, flow1, flow2,
        flow_bs, static_cast<float*>(out), out_bs, out_ps, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

// y (B, HW, C) = act(x + bias + add); act 0 none, 1 LeakyReLU(0.1), 2 ReLU;
// vec 8 (the vector instance) or 1 (the scalar one, any C, views aligned to
// their element only)
int vsrpp_bias_act_launch(int bf16, int act, const void* x, long long x_bs,
                          int x_ps, const float* bias, const void* add,
                          long long add_bs, int add_ps, void* y,
                          long long y_bs, int y_ps, int B, int HW, int C,
                          int vec, void* stream) {
  if ((vec != VEC && vec != 1) || !shape_ok(B, HW, C, vec) ||
      act < ACT_NONE || act > ACT_RELU || x_ps < C || y_ps < C ||
      (add && add_ps < C))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && vec == VEC)
    launch_bias_act<__nv_bfloat16, VEC>(act, st, x, x_bs, x_ps, bias, add,
                                        add_bs, add_ps, y, y_bs, y_ps, B, HW,
                                        C);
  else if (bf16)
    launch_bias_act<__nv_bfloat16, 1>(act, st, x, x_bs, x_ps, bias, add,
                                      add_bs, add_ps, y, y_bs, y_ps, B, HW, C);
  else if (vec == VEC)
    launch_bias_act<float, VEC>(act, st, x, x_bs, x_ps, bias, add, add_bs,
                                add_ps, y, y_bs, y_ps, B, HW, C);
  else
    launch_bias_act<float, 1>(act, st, x, x_bs, x_ps, bias, add, add_bs,
                              add_ps, y, y_bs, y_ps, B, HW, C);
  return static_cast<int>(cudaGetLastError());
}

// out and npair[..., :C] = (prop + (r + (yc + bias))) * gate,
// npair[..., C:] = pair[..., :C]; prop may be null
int vsrpp_gate_tail_launch(int bf16, const void* prop, long long prop_bs,
                           int prop_ps, const void* r, long long r_bs,
                           int r_ps, const void* yc, long long y_bs, int y_ps,
                           const float* bias, const void* gate, long long gbs,
                           long long gsy, long long gsx, const void* pair,
                           long long pair_bs, int pair_ps, void* out,
                           long long out_bs, int out_ps, void* npair,
                           long long npair_bs, int npair_ps, int B, int H,
                           int W, int C, void* stream) {
  if (!shape_ok(B, H * W, C) || H <= 0 || W <= 0 || !bias || !gate ||
      (prop && prop_ps < C) || r_ps < C || y_ps < C || pair_ps < 2 * C ||
      out_ps < C || npair_ps < 2 * C)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(H * W, C / VEC, B);
  if (bf16) {
    using T = __nv_bfloat16;
    vsrpp_gate_tail<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(prop), prop_bs, prop_ps,
        static_cast<const T*>(r), r_bs, r_ps, static_cast<const T*>(yc), y_bs,
        y_ps, bias, static_cast<const T*>(gate), gbs, gsy, gsx,
        static_cast<const T*>(pair), pair_bs, pair_ps, static_cast<T*>(out),
        out_bs, out_ps, static_cast<T*>(npair), npair_bs, npair_ps, W, H * W,
        C);
  } else {
    vsrpp_gate_tail<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(prop), prop_bs, prop_ps,
        static_cast<const float*>(r), r_bs, r_ps,
        static_cast<const float*>(yc), y_bs, y_ps, bias,
        static_cast<const float*>(gate), gbs, gsy, gsx,
        static_cast<const float*>(pair), pair_bs, pair_ps,
        static_cast<float*>(out), out_bs, out_ps, static_cast<float*>(npair),
        npair_bs, npair_ps, W, H * W, C);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vsrpp_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
