// 1-D affine resampling along one axis of a strided view, for Hopper (sm_90a):
// the forward, its exact adjoint and its position gradient. Two applications
// (x-pass, y-pass) make the separable affine warp of the STN.
//
//   view   x[o, u, j]     o < outer, u < l_in, j < inner (contiguous, j fastest)
//   lines  (o, j / channels): one (p, q) pair each, p and q of shape
//          (outer, inner / channels), float32
//   out[o, i, j] = sum_k K(t - k) * x[o, clamp(i0 + k, 0, l_in - 1), j]
//          pos = p * (o_base + i) + q,  i0 = floor(pos),  t = pos - i0,
//          k = 0, 1 (linear, K = triangle) or -1 .. 2 (cubic, K = Keys, A = -0.75);
//          with border == 0 a tap outside [0, l_in) reads 0 instead of the edge.
//   o_base: the first output index of the window computed, so that the l_out
//          outputs are outputs o_base .. o_base + l_out - 1 of a longer line.
//          On the spatial mesh axis a rank's y-pass computes its rows of the
//          warp (o_base its first row) from the whole intermediate, gathered
//          once: each output's position is the whole map's to the bit, so the
//          shard's forward equals those rows of the whole warp bit for bit.
//          Shifting q by p * o_base instead would round otherwise. o_base = 0
//          is the whole line, the launch of every caller without row shards.
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
// tfcgan_resample_fwd: one thread per output position i of one line, lines
// fastest, so a warp reads and writes neighbouring addresses in both passes
// (the x-pass's neighbouring pixels, the y-pass's neighbouring columns). The
// thread works out the position, its taps and their 2 or 4 weights once and
// applies them to all the line's channels: the 3 channels of a pixel in the
// x-pass, of a column in the y-pass. One integer division a thread (i and the
// line from the thread's index). At 3 channels (the image's) the channel
// loop is unrolled, so all 12 of a thread's cubic tap loads are in flight
// together; other counts loop at run time. x float32 or bfloat16, float32
// accumulation and output. What holds it back is latency more than bytes:
// each thread waits for p and q, then for its taps. The first design, a
// thread an output element, recomputed the position, the floor and the four
// branchy Keys weights for every channel and divided twice per element: 26 %
// of the byte bound at the path's shape (one warp at (32, 256, 256, 3)).
// Timed in turns by tools/kernel_turns.py on an NVIDIA H100 80GB HBM3 (700
// W), device alone, float32 image: that design 0.1108 ms; this one with the
// channel loop at run time 0.0656 ms; unrolled at 3 channels 0.0512 ms (59 %
// of the 0.0301 ms bound; 0.0473 ms with a bfloat16 image); the block's taps
// staged in shared memory and then one element a thread, channels fastest
// (every access coalesced, but a barrier and two dependent phases) 0.0793
// ms. The taps are scalar loads: a vector over j spans pixels of different
// lines when channels = 3.
//
// tfcgan_resample_adjoint: dx = A^T g in gather form, one launch, no atomics,
// no scratch, deterministic. A thread owns a strip of kAdjStrip neighbouring
// elements v0 .. v0 + 3 of one line (lines fastest, as in the forward) and
// all of the line's channels. It solves once for the positions i whose window
// can hold the strip, floor(p*i + q) in [v0 - hs, v0 + 3 + hs - 1] (hs = 1 or
// 2), with one element of slack on each side, and walks them in ascending
// order: each position's pos and floor (unfused multiply-add, exactly as the
// forward computes them) and its g for the line's channels once, then for
// each element of the strip whose tap the window holds the weight K((pos -
// i0) - k), the forward's own. Each element's sum is the same fmaf sequence
// over ascending i that a thread an element (the first design) takes: dx is
// that design's bit for bit. One element of slack is exact for every p: the
// rounding of p*i + q only moves a position across a bound onto the bound
// itself, where the window's end tap weighs 0. The walk's length follows (3 +
// 2*hs) / |p|: the TPU kernel's fixed window of 11 (cubic) or 7 (linear)
// offsets is exact only for |p| >= 0.5 and drops taps silently below; this
// walk stays exact for every p, p == 0 included (the whole line).
// Border clamping: taps outside [0, l_in) read the edge elements, so their
// weights belong to dx[.., 0, ..] and dx[.., l_in - 1, ..]. The positions
// whose window leaves the line at one end form one run at that end of [0,
// l_out) (which end follows the sign of p; for p == 0 all or none); the
// thread whose strip holds element 0 solves for the low run as the window is
// solved and walks it, adding g * (the weights of the taps below 0), and the
// one that holds l_in - 1 does the same for the high run (at l_in == 1 one
// thread, both runs). Near identity a run is a position or two. In the
// first design this was a kernel of its own launched first (a block a tile of j, the whole
// line split over slices, a shared-memory tree) into a scratch of (outer, 2,
// inner) floats that the wrapper allocated on every call; the edge elements'
// sums now run in sequence instead of a tree (within 6e-6 of that kernel's).
// Timed in turns by tools/kernel_turns.py on an NVIDIA H100 80GB HBM3 (700 W),
// device alone, the path's y-pass (32, 256, 768) float32 cubic: the two
// kernels of the first design 0.1209 ms; a thread an element of a line with
// all its channels 0.0635 ms; strips of 2, 4, 8 elements 0.0452, 0.0453,
// 0.0481 ms; strips of 4 with the walk unrolled by 2 at 64 registers 0.0420
// ms (28 % of the 0.0150 ms bound on the device alone; unrolled by 1 0.0453,
// by 2 at 86 registers 0.0549; strips of 2 unrolled by 4 0.0445). What holds
// it back is the walk's dependent steps (floor, test, weight) and its slack
// positions, not bytes: a strip's loads of g serve up to 4 elements each.
//
// tfcgan_resample_gradpos: gpos = g * sum_k K'(t - k) * x[tap] and, in the
// same kernel, gp[line] = sum_{i, channel} gpos * i and gq[line] = sum gpos:
// gpos never reaches device memory. A thread takes positions of one line in
// the forward's form (each position's taps and K' weights once, the line's
// channels after, unrolled at 3: 12 tap and 3 g loads in flight) and sums the
// channels into one gpos, in order. A block holds a tile of up to 32 lines
// (fastest, so the y-pass's loads coalesce over neighbouring columns) times
// slices of the positions; a thread walks its slice, at least kGradPer
// positions unrolled. The slices of a warp are summed with __shfl_down_sync
// in a fixed pattern, the block's warps through shared memory by one thread a
// line in warp order: one barrier, no atomics, the same bits run to run.
// Timed as the adjoint, both passes of the path's warp: the first design (a
// thread an element, two 7-level shared-memory trees a block and a serial
// channel sum) 0.1138 ms; this form at one position a thread 0.0580 ms (x-pass
// 0.0358, y-pass 0.0221); 4 positions a thread 0.0441 ms (x-pass 0.0226,
// y-pass 0.0216: 68 % of the 0.0301 ms bound); bfloat16 image 0.0430 ms. Also
// tried: staging the x-pass's row of x in shared memory before p and q are
// known (x-pass 0.0384, slower: a barrier and a copy for taps that L1 serves),
// a 3-block cap (40 registers: spills, x-pass 0.0629), the y-pass's walk unrolled by
// 4 (no change).
//
// What bounds all three: bytes. Per pass the forward reads x and writes out,
// the adjoint reads g and writes dx, the position gradient reads x and g and
// writes two floats a line. The 2 to 4 taps of neighbouring outputs overlap
// and are served by L1/L2.
//
// Not tried: p and q computed in the kernel from the six affine
// coefficients; both passes in one kernel through shared memory; the adjoint
// as a scatter of each position's 4 weights (atomics, or a sort by element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The position gradient: the most threads a block has, and the least
// positions of a line a thread takes (its walk unrolled by as many, so their
// loads are in flight together) where the line is short enough to leave the
// threads idle otherwise (the x-pass). Timed on the path's warp: blocks of
// 256, 512, 1024 at one position a thread 0.0588, 0.0580, 0.0610 ms; 1, 2, 4,
// 8 positions a thread at the x-pass 0.0358, 0.0261, 0.0226, 0.0221 ms.
constexpr int kGradThreads = 512;
constexpr int kGradPer = 4;
// The adjoint: neighbouring elements of a line a thread takes (a strip), its
// walk over the positions unrolled by 2, and blocks an SM it is compiled for:
// 4, so 64 registers (uncapped it took 86 and was 30 % slower)
constexpr int kAdjStrip = 4;
constexpr int kAdjUnroll = 2;
constexpr int kAdjMinBlocks = 4;
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

// The window of one output position pos along a line: where each of its 2
// or 4 taps reads (an element offset from the line's start at u = 0), its
// weight, and whether it reads at all (with border == 0 a tap outside [0,
// l_in) does not). The operations and order of the first forward's sum (a
// thread an element), so a sum over a line's channels with these taps is that
// sum, bit for bit.
template <bool Cubic>
struct Taps {
  static constexpr int kN = Cubic ? 4 : 2;
  int off[kN];
  float wgt[kN];
  bool on[kN];
};

// Deriv: the weights of K' instead of K (the position gradient's taps)
template <bool Cubic, bool Deriv = false>
__device__ __forceinline__ Taps<Cubic> window_taps(float pos, int l_in, int inner, int border) {
  constexpr int hs = Cubic ? 2 : 1;
  const float i0 = floorf(pos);
  const float t = pos - i0;
  const float last = static_cast<float>(l_in - 1);
  Taps<Cubic> taps;
#pragma unroll
  for (int k = -hs + 1; k <= hs; ++k) {
    const float u = i0 + static_cast<float>(k);
    taps.on[k + hs - 1] = border || (u >= 0.f && u <= last);
    taps.off[k + hs - 1] = static_cast<int>(fminf(fmaxf(u, 0.f), last)) * inner;
    taps.wgt[k + hs - 1] = Deriv ? kgrad<Cubic>(t - static_cast<float>(k))
                                 : kfn<Cubic>(t - static_cast<float>(k));
  }
  return taps;
}

// dst[ch] = sum over the taps of x at the tap, for the line's channels; C > 0
// is their count known at compile time (every load of the thread in flight
// together), 0 a count known at run time
template <typename T, bool Cubic, int C>
__device__ __forceinline__ void apply_taps(const T* xl, float* dst, const Taps<Cubic>& taps,
                                           int channels) {
#pragma unroll
  for (int ch = 0; ch < (C > 0 ? C : channels); ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < Taps<Cubic>::kN; ++k) {
      if (taps.on[k]) acc = fmaf(load_f32(xl + taps.off[k] + ch), taps.wgt[k], acc);
    }
    dst[ch] = acc;
  }
}

// grid.x: o; grid.y: chunks of the (l_out, lines) plane, lines = inner /
// channels. A thread: one output position i of one line, all the line's
// channels: the position, its taps and their weights once, then each
// channel's sum over the taps.
template <typename T, bool Cubic>
__global__ void __launch_bounds__(kThreads)
resample_fwd_kernel(const T* __restrict__ x, const float* __restrict__ p,
                    const float* __restrict__ q, float* __restrict__ out, int l_in, int l_out,
                    int inner, int channels, int lines, int border, int o_base) {
  const int e = blockIdx.y * kThreads + threadIdx.x;  // i * lines + line
  if (e >= l_out * lines) return;
  const int64_t o = blockIdx.x;
  const int i = e / lines;
  const int line = e - i * lines;
  const int64_t ln = o * lines + line;
  const Taps<Cubic> taps =
      window_taps<Cubic>(position(p[ln], q[ln], o_base + i), l_in, inner, border);
  const T* xl = x + o * l_in * inner + line * channels;
  float* dst = out + (o * l_out + i) * inner + line * channels;
  if (channels == 3) {
    apply_taps<T, Cubic, 3>(xl, dst, taps, 3);
  } else {
    apply_taps<T, Cubic, 0>(xl, dst, taps, channels);
  }
}

// The positions i of a line (p != 0) with p * (o_base + i) + q below bound
// (Below) or at or above it: one end of [0, l_out), as [first, last] with one
// element of slack, as the adjoint's window is solved (in whole-line indices,
// shifted by o_base once they are integers, so the shift is exact).
template <bool Below>
__device__ __forceinline__ void solve_side(float pl, float ql, float bound, int l_out,
                                           int o_base, int& first, int& last) {
  const float c = (bound - ql) / pl;
  const float ob = static_cast<float>(o_base);
  first = 0;
  last = l_out - 1;
  if ((pl > 0.f) == Below) {
    last = static_cast<int>(
        fmaxf(fminf(ceilf(c) + 1.f - ob, static_cast<float>(l_out - 1)), -1.f));
  } else {
    first = static_cast<int>(fminf(fmaxf(floorf(c) - 1.f - ob, 0.f), static_cast<float>(l_out)));
  }
}

// The mass that border clamping moves onto an edge element: Low, dx[0] gets
// sum_i g[i] * (the weights of i's taps below 0); else dx[l_in - 1] gets the
// same for the taps above l_in - 1. Only the positions whose window leaves
// the line at that end carry such taps: one run at that end of [0, l_out),
// solved, and each of its positions tested as a walk over the whole line
// would test it. acc[c] += the sum, for the channels c < nc of the chunk.
template <bool Cubic, int CB, bool Low>
__device__ __forceinline__ void add_edge_mass(const float* __restrict__ gl, float* acc, int nc,
                                              float pl, float ql, int l_in, int l_out,
                                              int inner, int o_base) {
  constexpr int hs = Cubic ? 2 : 1;
  const float last = static_cast<float>(l_in - 1);
  // Low: i0 - (hs - 1) < 0, that is pos < hs - 1; else i0 + hs > l_in - 1,
  // that is pos >= l_in - hs
  const float bound = Low ? static_cast<float>(hs - 1) : static_cast<float>(l_in - hs);
  int first = 0, end = l_out - 1;
  if (pl != 0.f) {
    solve_side<Low>(pl, ql, bound, l_out, o_base, first, end);
  }
  float m[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) m[c] = 0.f;
  for (int i = first; i <= end; ++i) {
    const float pos = position(pl, ql, o_base + i);
    const float i0 = floorf(pos);
    if (Low ? !(i0 - static_cast<float>(hs - 1) < 0.f) : !(i0 + static_cast<float>(hs) > last)) {
      continue;
    }
    const float t = pos - i0;
    float mass = 0.f;
#pragma unroll
    for (int k = -hs + 1; k <= hs; ++k) {
      const float u = i0 + static_cast<float>(k);
      const float wgt = kfn<Cubic>(t - static_cast<float>(k));
      if (Low ? u < 0.f : u > last) mass += wgt;
    }
    const float* gi = gl + static_cast<int64_t>(i) * inner;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c < nc) m[c] = fmaf(gi[c], mass, m[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] += m[c];
}

// dx[v, c] = sum_i g[i, c] * K(pos_i - v) over the positions i whose window
// holds v, for a strip of nv <= V neighbouring elements v0 .. v0 + nv - 1 and
// the channels c < nc of one chunk of a line (CB of them at compile time),
// and the edge masses where v is an edge element. The strip's positions
// [first, last] are walked once: each one's floor, its g and its test are
// shared by the strip's elements, and each element's sum is the same sequence
// of fmaf over ascending i as a thread an element would take.
template <bool Cubic, int CB, int V>
__device__ __forceinline__ void adjoint_strip(const float* __restrict__ gl,
                                              float* __restrict__ dst, int nc, int nv, float pl,
                                              float ql, int first, int last, int v0, int l_in,
                                              int l_out, int inner, int border, int o_base) {
  constexpr int hs = Cubic ? 2 : 1;
  float acc[V][CB];
#pragma unroll
  for (int d = 0; d < V; ++d) {
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[d][c] = 0.f;
  }
#pragma unroll kAdjUnroll
  for (int i = first; i <= last; ++i) {
    const float pos = position(pl, ql, o_base + i);
    const float i0 = floorf(pos);
    const float* gi = gl + static_cast<int64_t>(i) * inner;
    float gv[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) gv[c] = c < nc ? gi[c] : 0.f;
#pragma unroll
    for (int d = 0; d < V; ++d) {
      const float k = static_cast<float>(v0 + d) - i0;  // the tap of i that reads v0 + d
      if (d < nv && k >= static_cast<float>(-hs + 1) && k <= static_cast<float>(hs)) {
        const float wgt = kfn<Cubic>((pos - i0) - k);
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[d][c] = fmaf(gv[c], wgt, acc[d][c]);
      }
    }
  }
  if (border) {
    if (v0 == 0) {
      add_edge_mass<Cubic, CB, true>(gl, acc[0], nc, pl, ql, l_in, l_out, inner, o_base);
    }
    if (v0 + nv == l_in) {
#pragma unroll
      for (int d = 0; d < V; ++d) {
        if (d == nv - 1) {
          add_edge_mass<Cubic, CB, false>(gl, acc[d], nc, pl, ql, l_in, l_out, inner, o_base);
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < V; ++d) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (d < nv && c < nc) dst[static_cast<int64_t>(d) * inner + c] = acc[d][c];
    }
  }
}

// grid.x: o; grid.y: chunks of the (strips, lines) plane, a strip kAdjStrip
// neighbouring elements of a line. A thread: one strip of one line, all the
// line's channels: the positions whose windows hold the strip solved once,
// each position's floor and g once, then its weight for each element.
template <bool Cubic>
__global__ void __launch_bounds__(kThreads, kAdjMinBlocks)
resample_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ p,
                        const float* __restrict__ q, float* __restrict__ dx, int l_in, int l_out,
                        int inner, int channels, int lines, int border, int o_base) {
  constexpr int hs = Cubic ? 2 : 1;
  const int strips = (l_in + kAdjStrip - 1) / kAdjStrip;
  const int e = blockIdx.y * kThreads + threadIdx.x;  // strip * lines + line
  if (e >= strips * lines) return;
  const int64_t o = blockIdx.x;
  const int strip = e / lines;
  const int line = e - strip * lines;
  const int v0 = strip * kAdjStrip;
  const int nv = min(kAdjStrip, l_in - v0);
  const int64_t ln = o * lines + line;
  const float pl = p[ln], ql = q[ln];

  // every i with p*(o_base + i) + q in [v0 - hs, v0 + nv - 1 + hs), one
  // element of slack each side (the windows of the strip's elements, solved
  // at its two ends in whole-line indices, then shifted by o_base)
  int first = 0, last = l_out - 1;
  if (pl != 0.f) {
    const float a = (static_cast<float>(v0 - hs) - ql) / pl;
    const float b = (static_cast<float>(v0 + nv - 1 + hs) - ql) / pl;
    const float ob = static_cast<float>(o_base);
    first = static_cast<int>(fminf(fmaxf(floorf(fminf(a, b)) - 1.f - ob, 0.f),
                                   static_cast<float>(l_out)));
    last = static_cast<int>(fmaxf(fminf(ceilf(fmaxf(a, b)) + 1.f - ob,
                                        static_cast<float>(l_out - 1)), -1.f));
  }
  const float* gl = g + o * l_out * inner + line * channels;
  float* dst = dx + (o * l_in + v0) * inner + line * channels;
  if (channels == 3) {
    adjoint_strip<Cubic, 3, kAdjStrip>(gl, dst, 3, nv, pl, ql, first, last, v0, l_in, l_out,
                                       inner, border, o_base);
  } else {
    for (int c0 = 0; c0 < channels; c0 += 4) {
      adjoint_strip<Cubic, 4, kAdjStrip>(gl + c0, dst + c0, min(4, channels - c0), nv, pl, ql,
                                         first, last, v0, l_in, l_out, inner, border, o_base);
    }
  }
}

// sum over the line's channels of g * (sum over the taps of K'(t - k) x): the
// position gradient of one (line, position), channels in order; C as in
// apply_taps
template <typename T, bool Cubic, int C>
__device__ __forceinline__ float channel_grad_sum(const T* xl, const float* gi,
                                                  const Taps<Cubic>& taps, int channels) {
  float sum = 0.f;
#pragma unroll
  for (int ch = 0; ch < (C > 0 ? C : channels); ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < Taps<Cubic>::kN; ++k) {
      if (taps.on[k]) acc = fmaf(load_f32(xl + taps.off[k] + ch), taps.wgt[k], acc);
    }
    sum = fmaf(gi[ch], acc, sum);
  }
  return sum;
}

// gp[line] = sum_{i, channel} gpos * i, gq[line] = sum gpos,
// gpos = g[o, i, j] * sum_k K'(t - k) * x[tap].
// grid.x: o; grid.y: tiles of 2^tl_log2 <= 32 lines. Block: those lines
// (fastest) times blockDim.x >> tl_log2 slices of the positions; a thread
// walks its slice's positions (i = slice, slice + slices, ...), each one's
// position, taps and K' weights once for the line's channels. The slices of
// a warp are then summed by shuffles, the block's warps through shared
// memory, both in a fixed order: the result repeats bit for bit.
template <typename T, bool Cubic>
__global__ void __launch_bounds__(kGradThreads)
resample_gradpos_kernel(const T* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ p, const float* __restrict__ q,
                        float* __restrict__ gp, float* __restrict__ gq, int l_in, int l_out,
                        int inner, int channels, int lines, int border, int o_base,
                        int tl_log2) {
  __shared__ float s_p[kGradThreads / 32][32], s_q[kGradThreads / 32][32];
  const int tl = 1 << tl_log2;
  const int slice = threadIdx.x >> tl_log2, slices = blockDim.x >> tl_log2;
  const int line = blockIdx.y * tl + (threadIdx.x & (tl - 1));
  const int64_t o = blockIdx.x;
  float sum_p = 0.f, sum_q = 0.f;
  if (line < lines) {
    const int64_t ln = o * lines + line;
    const float pl = p[ln], ql = q[ln];
    const T* xl = x + o * l_in * inner + line * channels;
    const float* gl = g + o * l_out * inner + line * channels;
#pragma unroll kGradPer
    for (int i = slice; i < l_out; i += slices) {
      const Taps<Cubic> taps =
          window_taps<Cubic, true>(position(pl, ql, o_base + i), l_in, inner, border);
      const float* gi = gl + static_cast<int64_t>(i) * inner;
      const float gpos = channels == 3 ? channel_grad_sum<T, Cubic, 3>(xl, gi, taps, 3)
                                       : channel_grad_sum<T, Cubic, 0>(xl, gi, taps, channels);
      sum_p = fmaf(gpos, static_cast<float>(o_base + i), sum_p);
      sum_q += gpos;
    }
  }
  // lanes l and l + off hold the same line: after the last step lanes 0 ..
  // tl - 1 hold their warp's sums
  for (int off = 16; off >= tl; off >>= 1) {
    sum_p += __shfl_down_sync(0xffffffffu, sum_p, off);
    sum_q += __shfl_down_sync(0xffffffffu, sum_q, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < tl) {
    s_p[warp][lane] = sum_p;
    s_q[warp][lane] = sum_q;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < tl && line < lines) {
    float tot_p = s_p[0][threadIdx.x], tot_q = s_q[0][threadIdx.x];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      tot_p += s_p[w][threadIdx.x];
      tot_q += s_q[w][threadIdx.x];
    }
    gp[o * lines + line] = tot_p;
    gq[o * lines + line] = tot_q;
  }
}

dim3 plane_grid(int64_t outer, int length, int inner) {
  return dim3(static_cast<unsigned>(outer),
              static_cast<unsigned>((static_cast<int64_t>(length) * inner + kThreads - 1) /
                                    kThreads));
}

template <typename T>
void launch_fwd(const void* x, const float* p, const float* q, float* out, int64_t outer,
                int l_in, int l_out, int inner, int channels, int cubic, int border, int o_base,
                cudaStream_t s) {
  const int lines = inner / channels;
  const dim3 grid = plane_grid(outer, l_out, lines);
  const T* xs = static_cast<const T*>(x);
  if (cubic) {
    resample_fwd_kernel<T, true><<<grid, kThreads, 0, s>>>(xs, p, q, out, l_in, l_out, inner,
                                                           channels, lines, border, o_base);
  } else {
    resample_fwd_kernel<T, false><<<grid, kThreads, 0, s>>>(xs, p, q, out, l_in, l_out, inner,
                                                            channels, lines, border, o_base);
  }
}

template <typename T>
void launch_gradpos(const void* x, const float* g, const float* p, const float* q, float* gp,
                    float* gq, int64_t outer, int l_in, int l_out, int inner, int channels,
                    int cubic, int border, int o_base, cudaStream_t s) {
  const int lines = inner / channels;
  // a tile of the fewest powers of two lines that holds them all, 32 at most;
  // slices until every position has one or the block is full, a warp at least
  int tl_log2 = 0;
  while ((1 << tl_log2) < lines && tl_log2 < 5) ++tl_log2;
  int threads = 1 << tl_log2;
  while (threads < kGradThreads &&
         static_cast<int64_t>(threads) * kGradPer < (static_cast<int64_t>(l_out) << tl_log2)) {
    threads *= 2;
  }
  if (threads < 32) threads = 32;
  const dim3 grid(static_cast<unsigned>(outer),
                  static_cast<unsigned>((lines + (1 << tl_log2) - 1) >> tl_log2));
  const T* xs = static_cast<const T*>(x);
  if (cubic) {
    resample_gradpos_kernel<T, true><<<grid, threads, 0, s>>>(xs, g, p, q, gp, gq, l_in, l_out,
                                                              inner, channels, lines, border,
                                                              o_base, tl_log2);
  } else {
    resample_gradpos_kernel<T, false><<<grid, threads, 0, s>>>(xs, g, p, q, gp, gq, l_in, l_out,
                                                               inner, channels, lines, border,
                                                               o_base, tl_log2);
  }
}

}  // namespace

// All three take the view (outer, length, inner) of a contiguous tensor on the
// current device, p and q as contiguous float32 (outer, inner / channels), and
// return cudaGetLastError(). The caller checks: inner a multiple of channels
// (any count: a thread loops over a line's channels), lengths >= 1, outer <
// 2^31, length * inner <= 65535 * 256 (grid.y of the forward and the adjoint).
// dtype: 0 = float32, 1 = bfloat16 (of x); g, out, dx, gp, gq are float32.
// o_base >= 0: the outputs are positions o_base .. o_base + l_out - 1 of the
// line (0: the whole line, positions 0 .. l_out - 1).

extern "C" int tfcgan_resample_fwd(const void* x, const float* p, const float* q, float* out,
                                   int64_t outer, int l_in, int l_out, int inner, int channels,
                                   int cubic, int border, int o_base, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fwd<float>(x, p, q, out, outer, l_in, l_out, inner, channels, cubic, border, o_base,
                      s);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(x, p, q, out, outer, l_in, l_out, inner, channels, cubic, border,
                              o_base, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx (outer, l_in, inner) = A^T g for g (outer, l_out, inner), the edge
// masses included: one launch, no scratch.
extern "C" int tfcgan_resample_adjoint(const float* g, const float* p, const float* q, float* dx,
                                       int64_t outer, int l_in, int l_out, int inner,
                                       int channels, int cubic, int border, int o_base,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lines = inner / channels;
  const dim3 grid = plane_grid(outer, (l_in + kAdjStrip - 1) / kAdjStrip, lines);
  if (cubic) {
    resample_adjoint_kernel<true><<<grid, kThreads, 0, s>>>(g, p, q, dx, l_in, l_out, inner,
                                                            channels, lines, border, o_base);
  } else {
    resample_adjoint_kernel<false><<<grid, kThreads, 0, s>>>(g, p, q, dx, l_in, l_out, inner,
                                                             channels, lines, border, o_base);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tfcgan_resample_gradpos(const void* x, const float* g, const float* p,
                                       const float* q, float* gp, float* gq, int64_t outer,
                                       int l_in, int l_out, int inner, int channels, int cubic,
                                       int border, int o_base, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_gradpos<float>(x, g, p, q, gp, gq, outer, l_in, l_out, inner, channels, cubic, border,
                          o_base, s);
  } else if (dtype == 1) {
    launch_gradpos<__nv_bfloat16>(x, g, p, q, gp, gq, outer, l_in, l_out, inner, channels, cubic,
                                  border, o_base, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
