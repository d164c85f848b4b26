// 1-D affine resampling along one axis of a strided view, for Hopper (sm_90a):
// the forward, its exact adjoint and its position gradient. Two applications
// (x-pass, y-pass) make the separable affine warp of the STN.
//
//   view   x[o, u, j]     o < outer, u < l_in, j < inner (contiguous, j fastest)
//   lines  (o, j / channels): one (p, q) pair each, p and q of shape
//          (outer, inner / channels), float32
//   out[o, i, j] = sum_k K(t - k) * x[o, clamp(i0 + k, 0, l_in - 1), j]
//          pos = p * i + q,  i0 = floor(pos),  t = pos - i0,
//          k = 0, 1 (linear, K = triangle) or -1 .. 2 (cubic, K = Keys, A = -0.75);
//          with border == 0 a tap outside [0, l_in) reads 0 instead of the edge.
//
// Replaces the TPU kernels of tfcgan_tpu/ops/pallas_kernels/resample.py
// (_fwd_kernel, _adjoint_kernel, _grad_pos_kernel, all reached through
// _call_rowwise and resample_affine_lanes). Those work on rows padded to 128
// lanes with a chunked lane gather, a division-free lane-to-pixel trick and a
// transposed copy of the image around the y-pass; none of that has a reason
// here. The resampled axis is taken by strides instead: the x-pass sees the
// NHWC image as (N*H, W, C) and the y-pass as (N, H, W*C), so column taps are
// read at stride W*C and no transposed copy is ever written.
//
// tfcgan_resample_fwd: one thread per output element, j fastest, so a warp
// reads and writes neighbouring addresses in both passes. x float32 or
// bfloat16, float32 accumulation and output.
//
// tfcgan_resample_adjoint: dx = A^T g in gather form, one thread per dx
// element, no atomics, so the result is deterministic. The thread for (o, v, j)
// visits every i whose window can hold v, that is floor(p*i + q) in
// [v - hs, v + hs - 1] (hs = 1 or 2), found by solving for i with one element
// of slack on each side, and recomputes pos, i0 and t exactly as the forward
// does (unfused multiply-add), so it transposes the forward's own weights. The
// loop length follows 2*hs / |p|: the TPU kernel's fixed window of 11 (cubic)
// or 7 (linear) offsets is exact only for |p| >= 0.5 and drops taps silently
// below; this loop stays exact for every p, p == 0 included (the whole line).
// Under border clamping the taps that fell outside [0, l_in) were read from
// the two edge elements, so their weights belong to dx[.., 0, ..] and
// dx[.., l_in - 1, ..]: a reduction over the whole line for 2 of its
// elements. A small kernel run first (resample_edge_kernel, same launcher)
// computes it into a scratch (outer, 2, inner): a block owns a tile of j and
// splits the line over the rest of its threads, skips every i whose window
// lies inside the line without loading g (for near-identity warps that is
// almost all of them), and sums the partial masses in shared memory with a
// fixed-order tree. The gather kernel adds the two values where v is an edge.
//
// tfcgan_resample_gradpos: gpos[o, i, j] = g * sum_k K'(t - k) * x[tap] and,
// fused in the same kernel, gp[line] = sum_{i, channel} gpos * i and
// gq[line] = sum gpos, so gpos never reaches device memory. Same block shape
// as the edge kernel: a tile of j (whole lines) times slices of i, a
// fixed-order tree over the slices in shared memory, then the channels of a
// line summed in order by one thread.
//
// What bounds all three: bytes. Per pass the forward reads x and writes out,
// the adjoint reads g (twice where lines leave the image) and writes dx, the
// position gradient reads x and g and writes two floats a line. The 2 to 4
// taps of neighbouring outputs overlap and are served by L1/L2.
//
// Left for later work: computing p and q in the kernel from the six affine
// coefficients, both passes in one kernel through shared memory, 16-byte
// loads, and folding the edge pass into the gather kernel's launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kA = -0.75f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Interpolation kernel K(x): triangle, or Keys cubic convolution with A = -0.75.
template <bool Cubic>
__device__ __forceinline__ float kfn(float x) {
  const float ax = fabsf(x);
  if constexpr (Cubic) {
    const float in1 = ((kA + 2.f) * ax - (kA + 3.f)) * ax * ax + 1.f;
    const float in2 = ((kA * ax - 5.f * kA) * ax + 8.f * kA) * ax - 4.f * kA;
    return ax <= 1.f ? in1 : (ax < 2.f ? in2 : 0.f);
  } else {
    return fmaxf(0.f, 1.f - ax);
  }
}

// dK/dx, piecewise; 0 at x == 0 and outside the support.
template <bool Cubic>
__device__ __forceinline__ float kgrad(float x) {
  const float ax = fabsf(x);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  if constexpr (Cubic) {
    const float d1 = (3.f * (kA + 2.f) * ax - 2.f * (kA + 3.f)) * ax;
    const float d2 = (3.f * kA * ax - 10.f * kA) * ax + 8.f * kA;
    return s * (ax <= 1.f ? d1 : (ax < 2.f ? d2 : 0.f));
  } else {
    return ax < 1.f ? -s : 0.f;
  }
}

// pos = p * i + q with the product rounded before the sum, as plain tensor
// code computes it: forward, adjoint and position gradient then agree on i0.
__device__ __forceinline__ float position(float p, float q, int i) {
  return __fadd_rn(__fmul_rn(p, static_cast<float>(i)), q);
}

// sum_k W(t - k) * x[tap k] over the window of pos, W = K or K'.
template <typename T, bool Cubic, bool Grad>
__device__ __forceinline__ float window_sum(const T* xl, float pos, int l_in, int inner,
                                            int border) {
  constexpr int hs = Cubic ? 2 : 1;
  const float i0 = floorf(pos);
  const float t = pos - i0;
  const float last = static_cast<float>(l_in - 1);
  float acc = 0.f;
#pragma unroll
  for (int k = -hs + 1; k <= hs; ++k) {
    const float u = i0 + static_cast<float>(k);
    if (!border && !(u >= 0.f && u <= last)) continue;
    const int uc = static_cast<int>(fminf(fmaxf(u, 0.f), last));
    const float wgt = Grad ? kgrad<Cubic>(t - static_cast<float>(k))
                           : kfn<Cubic>(t - static_cast<float>(k));
    acc = fmaf(load_f32(xl + static_cast<int64_t>(uc) * inner), wgt, acc);
  }
  return acc;
}

// grid.x: o; grid.y: chunks of the (l_out, inner) plane.
template <typename T, bool Cubic>
__global__ void __launch_bounds__(kThreads)
resample_fwd_kernel(const T* __restrict__ x, const float* __restrict__ p,
                    const float* __restrict__ q, float* __restrict__ out, int l_in, int l_out,
                    int inner, int channels, int border) {
  const int e = blockIdx.y * kThreads + threadIdx.x;  // i * inner + j
  if (e >= l_out * inner) return;
  const int64_t o = blockIdx.x;
  const int i = e / inner;
  const int j = e - i * inner;
  const int64_t line = o * (inner / channels) + j / channels;
  const float pos = position(p[line], q[line], i);
  const T* xl = x + o * l_in * inner + j;
  out[o * l_out * inner + e] = window_sum<T, Cubic, false>(xl, pos, l_in, inner, border);
}

// Block shape of the two reducing kernels: tj neighbouring j (whole lines)
// times tx slices of the resampled axis; tx_pow2 is the power of two >= tx.
struct Tile {
  int tj, tx, tx_pow2;
};

Tile make_tile(int inner, int channels) {
  Tile t;
  t.tj = inner <= 32 ? inner : channels * (32 / channels > 0 ? 32 / channels : 1);
  t.tx = kThreads / t.tj > 0 ? kThreads / t.tj : 1;
  t.tx_pow2 = 1;
  while (t.tx_pow2 < t.tx) t.tx_pow2 *= 2;
  return t;
}

// Sum s[tj + tx * tile.tj] over tx into s[tj], pairs in a fixed order. Every
// thread of the block calls it.
__device__ __forceinline__ void reduce_slices(float* s, Tile tile, int tx) {
  __syncthreads();
  for (int step = tile.tx_pow2 / 2; step > 0; step >>= 1) {
    if (tx < step && tx + step < tile.tx) s[threadIdx.x] += s[threadIdx.x + step * tile.tj];
    __syncthreads();
  }
}

// edge[o, 0, j] = sum_i g[o, i, j] * (weight of the taps below 0),
// edge[o, 1, j] = the same for the taps above l_in - 1.
// grid.x: o; grid.y: tiles of j; block: tile.tj * tile.tx threads.
template <bool Cubic>
__global__ void __launch_bounds__(kThreads)
resample_edge_kernel(const float* __restrict__ g, const float* __restrict__ p,
                     const float* __restrict__ q, float* __restrict__ edge, int l_in,
                     int l_out, int inner, int channels, Tile tile) {
  constexpr int hs = Cubic ? 2 : 1;
  __shared__ float s_lo[kThreads], s_hi[kThreads];
  const int tj = threadIdx.x % tile.tj, tx = threadIdx.x / tile.tj;
  const int j = blockIdx.y * tile.tj + tj;
  const int64_t o = blockIdx.x;
  float lo = 0.f, hi = 0.f;
  if (j < inner) {
    const int64_t line = o * (inner / channels) + j / channels;
    const float pl = p[line], ql = q[line];
    const float last = static_cast<float>(l_in - 1);
    const float* gl = g + o * l_out * inner + j;
    for (int i = tx; i < l_out; i += tile.tx) {
      const float pos = position(pl, ql, i);
      const float i0 = floorf(pos);
      if (i0 - static_cast<float>(hs - 1) >= 0.f && i0 + static_cast<float>(hs) <= last) continue;
      const float t = pos - i0;
      float m_lo = 0.f, m_hi = 0.f;
#pragma unroll
      for (int k = -hs + 1; k <= hs; ++k) {
        const float u = i0 + static_cast<float>(k);
        const float wgt = kfn<Cubic>(t - static_cast<float>(k));
        if (u < 0.f) m_lo += wgt;
        if (u > last) m_hi += wgt;
      }
      const float gv = gl[static_cast<int64_t>(i) * inner];
      lo = fmaf(gv, m_lo, lo);
      hi = fmaf(gv, m_hi, hi);
    }
  }
  s_lo[threadIdx.x] = lo;
  s_hi[threadIdx.x] = hi;
  reduce_slices(s_lo, tile, tx);
  reduce_slices(s_hi, tile, tx);
  if (tx == 0 && j < inner) {
    edge[(o * 2 + 0) * inner + j] = s_lo[tj];
    edge[(o * 2 + 1) * inner + j] = s_hi[tj];
  }
}

// grid.x: o; grid.y: chunks of the (l_in, inner) plane.
template <bool Cubic>
__global__ void __launch_bounds__(kThreads)
resample_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ p,
                        const float* __restrict__ q, const float* __restrict__ edge,
                        float* __restrict__ dx, int l_in, int l_out, int inner, int channels,
                        int border) {
  constexpr int hs = Cubic ? 2 : 1;
  const int e = blockIdx.y * kThreads + threadIdx.x;  // v * inner + j
  if (e >= l_in * inner) return;
  const int64_t o = blockIdx.x;
  const int v = e / inner;
  const int j = e - v * inner;
  const int64_t line = o * (inner / channels) + j / channels;
  const float pl = p[line], ql = q[line];

  // every i with p*i + q in [v - hs, v + hs), one element of slack each side
  int first = 0, last = l_out - 1;
  if (pl != 0.f) {
    const float a = (static_cast<float>(v - hs) - ql) / pl;
    const float b = (static_cast<float>(v + hs) - ql) / pl;
    first = static_cast<int>(fminf(fmaxf(floorf(fminf(a, b)) - 1.f, 0.f),
                                   static_cast<float>(l_out)));
    last = static_cast<int>(fmaxf(fminf(ceilf(fmaxf(a, b)) + 1.f, static_cast<float>(l_out - 1)),
                                  -1.f));
  }
  const float* gl = g + o * l_out * inner + j;
  const float vf = static_cast<float>(v);
  float acc = 0.f;
  for (int i = first; i <= last; ++i) {
    const float pos = position(pl, ql, i);
    const float i0 = floorf(pos);
    const float k = vf - i0;  // the tap of i that reads v, if it is in the window
    if (k >= static_cast<float>(-hs + 1) && k <= static_cast<float>(hs)) {
      acc = fmaf(gl[static_cast<int64_t>(i) * inner], kfn<Cubic>((pos - i0) - k), acc);
    }
  }
  if (border) {
    if (v == 0) acc += edge[(o * 2 + 0) * inner + j];
    if (v == l_in - 1) acc += edge[(o * 2 + 1) * inner + j];
  }
  dx[o * l_in * inner + e] = acc;
}

// gp[line] = sum_{i, channel} gpos * i, gq[line] = sum gpos,
// gpos = g[o, i, j] * sum_k K'(t - k) * x[tap].
// grid.x: o; grid.y: tiles of j (whole lines); block: tile.tj * tile.tx threads.
template <typename T, bool Cubic>
__global__ void __launch_bounds__(kThreads)
resample_gradpos_kernel(const T* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ p, const float* __restrict__ q,
                        float* __restrict__ gp, float* __restrict__ gq, int l_in, int l_out,
                        int inner, int channels, int border, Tile tile) {
  __shared__ float s_p[kThreads], s_q[kThreads];
  const int tj = threadIdx.x % tile.tj, tx = threadIdx.x / tile.tj;
  const int j = blockIdx.y * tile.tj + tj;
  const int64_t o = blockIdx.x;
  const int lines = inner / channels;
  float sum_p = 0.f, sum_q = 0.f;
  if (j < inner) {
    const int64_t line = o * lines + j / channels;
    const float pl = p[line], ql = q[line];
    const T* xl = x + o * l_in * inner + j;
    const float* gl = g + o * l_out * inner + j;
    for (int i = tx; i < l_out; i += tile.tx) {
      const float gpos = gl[static_cast<int64_t>(i) * inner] *
                         window_sum<T, Cubic, true>(xl, position(pl, ql, i), l_in, inner, border);
      sum_p = fmaf(gpos, static_cast<float>(i), sum_p);
      sum_q += gpos;
    }
  }
  s_p[threadIdx.x] = sum_p;
  s_q[threadIdx.x] = sum_q;
  reduce_slices(s_p, tile, tx);
  reduce_slices(s_q, tile, tx);
  if (tx == 0 && j < inner && tj % channels == 0) {
    float tot_p = 0.f, tot_q = 0.f;
    for (int c = 0; c < channels; ++c) {
      tot_p += s_p[tj + c];
      tot_q += s_q[tj + c];
    }
    const int64_t line = o * lines + j / channels;
    gp[line] = tot_p;
    gq[line] = tot_q;
  }
}

dim3 plane_grid(int64_t outer, int length, int inner) {
  return dim3(static_cast<unsigned>(outer),
              static_cast<unsigned>((static_cast<int64_t>(length) * inner + kThreads - 1) /
                                    kThreads));
}

dim3 tile_grid(int64_t outer, int inner, Tile tile) {
  return dim3(static_cast<unsigned>(outer), static_cast<unsigned>((inner + tile.tj - 1) / tile.tj));
}

template <typename T>
void launch_fwd(const void* x, const float* p, const float* q, float* out, int64_t outer,
                int l_in, int l_out, int inner, int channels, int cubic, int border,
                cudaStream_t s) {
  const dim3 grid = plane_grid(outer, l_out, inner);
  const T* xs = static_cast<const T*>(x);
  if (cubic) {
    resample_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(xs, p, q, out, l_in, l_out, inner,
                                                           channels, border);
  } else {
    resample_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(xs, p, q, out, l_in, l_out, inner,
                                                            channels, border);
  }
}

template <typename T>
void launch_gradpos(const void* x, const float* g, const float* p, const float* q, float* gp,
                    float* gq, int64_t outer, int l_in, int l_out, int inner, int channels,
                    int cubic, int border, cudaStream_t s) {
  const Tile tile = make_tile(inner, channels);
  const dim3 grid = tile_grid(outer, inner, tile);
  const int threads = tile.tj * tile.tx;
  const T* xs = static_cast<const T*>(x);
  if (cubic) {
    resample_gradpos_kernel<T, true><<<grid, threads, 0, s>>>(xs, g, p, q, gp, gq, l_in, l_out,
                                                              inner, channels, border, tile);
  } else {
    resample_gradpos_kernel<T, false><<<grid, threads, 0, s>>>(xs, g, p, q, gp, gq, l_in, l_out,
                                                               inner, channels, border, tile);
  }
}

}  // namespace

// All three take the view (outer, length, inner) of a contiguous tensor on the
// current device, p and q as contiguous float32 (outer, inner / channels), and
// return cudaGetLastError(). The caller checks: inner a multiple of channels,
// channels <= 256, lengths >= 1, outer < 2^31, length * inner <= 65535 * 256.
// dtype: 0 = float32, 1 = bfloat16 (of x); g, out, dx, gp, gq, edge are float32.

extern "C" int tfcgan_resample_fwd(const void* x, const float* p, const float* q, float* out,
                                   int64_t outer, int l_in, int l_out, int inner, int channels,
                                   int cubic, int border, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fwd<float>(x, p, q, out, outer, l_in, l_out, inner, channels, cubic, border, s);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(x, p, q, out, outer, l_in, l_out, inner, channels, cubic, border, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx (outer, l_in, inner) = A^T g for g (outer, l_out, inner). With border,
// edge is a scratch of (outer, 2, inner) floats that the first kernel fills;
// without, it is not read.
extern "C" int tfcgan_resample_adjoint(const float* g, const float* p, const float* q,
                                       float* edge, float* dx, int64_t outer, int l_in,
                                       int l_out, int inner, int channels, int cubic, int border,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (border) {
    const Tile tile = make_tile(inner, channels);
    const dim3 grid = tile_grid(outer, inner, tile);
    const int threads = tile.tj * tile.tx;
    if (cubic) {
      resample_edge_kernel<true><<<grid, threads, 0, s>>>(g, p, q, edge, l_in, l_out, inner,
                                                          channels, tile);
    } else {
      resample_edge_kernel<false><<<grid, threads, 0, s>>>(g, p, q, edge, l_in, l_out, inner,
                                                           channels, tile);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid = plane_grid(outer, l_in, inner);
  if (cubic) {
    resample_adjoint_kernel<true><<<grid, kThreads, 0, s>>>(g, p, q, edge, dx, l_in, l_out,
                                                            inner, channels, border);
  } else {
    resample_adjoint_kernel<false><<<grid, kThreads, 0, s>>>(g, p, q, edge, dx, l_in, l_out,
                                                             inner, channels, border);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tfcgan_resample_gradpos(const void* x, const float* g, const float* p,
                                       const float* q, float* gp, float* gq, int64_t outer,
                                       int l_in, int l_out, int inner, int channels, int cubic,
                                       int border, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_gradpos<float>(x, g, p, q, gp, gq, outer, l_in, l_out, inner, channels, cubic, border,
                          s);
  } else if (dtype == 1) {
    launch_gradpos<__nv_bfloat16>(x, g, p, q, gp, gq, outer, l_in, l_out, inner, channels, cubic,
                                  border, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
