// Bilinear grid_sample on a dense (per-pixel) grid and its exact backward, for
// Hopper (sm_90a). NHWC image, normalized (x, y) grid, torch's F.grid_sample
// semantics:
//
//   inp  (N, H, W, C)    float32 or bfloat16, contiguous
//   grid (N, Hg, Wg, 2)  float32, x along W and y along H, in [-1, 1] over the image
//   out[n, i, j, c] = sum over the 4 taps (y0 + dy, x0 + dx) of
//                     w_dy * w_dx * inp[n, y0 + dy, x0 + dx, c]
//          ix = unnormalize(grid x)   (align_corners: ((g + 1) / 2) * (W - 1),
//                                      else ((g + 1) * W - 1) / 2)
//          x0 = floor(ix), tx = ix - x0, w_0 = 1 - tx, w_1 = tx; the same along y
//   padding zeros:      a tap off the image reads 0
//           border:     a tap off the image reads the edge pixel (index clamped)
//           reflection: ix is folded into the image first (torch's
//                       reflect_coordinates, then clipped), then as border
//
// Replaces the TPU kernels of tfcgan_tpu/ops/pallas_kernels/gridsample.py
// (_fwd_kernel and _bwd_kernel, reached through _sample_padded, _sp_bwd and
// grid_sample_dense). Those turn the gather into matrix products with one-hot
// weight matrices, one (H, W_in) @ (W_in, W_out) product per output row and
// channel, on images padded to 128 lanes in a channel-major layout, because
// that machine has no gather. This card has one: the function is 4 loads and 4
// multiply-adds per output element, and nothing of that design is kept.
//
// tfcgan_gridsample_fwd: a block of 256 threads owns 256 consecutive output
// pixels. Each thread first works out one pixel's two axes (the grid read as
// one float2, 32-bit indices, no division but the image index) into shared
// memory: the four tap offsets and the four products of the axis weights. Then
// the block's threads walk its output (C channels a pixel, contiguous) in
// vectors of V channels, V the widest that C and the pointers allow (up to 16
// bytes: 4 float32 or 8 bfloat16; 2 at the path's C = 6, 1 for odd C), each
// reading its pixel's taps from shared memory, the four taps' V channels as
// one load each, and writing its V outputs as one store: a warp's stores are
// contiguous. float32 arithmetic, output in inp's dtype. What bounds it now:
// bytes in float32 (it reads inp and grid once and writes out; the 4 taps of
// neighbouring outputs overlap and are served by L1/L2): 70 % of the byte
// bound at the path's shape. In bfloat16, with half the image bytes, about
// half: a block's two round trips to memory one after the other (the grid,
// then the taps) weigh as much as its bytes. A thread an output element, the
// first design, was bound by instructions instead: two 64-bit divisions and
// both axes' coordinate arithmetic for every channel, and a 2- or 4-byte load
// for every tap and channel (34 % of the byte bound and behind F.grid_sample
// at the path's shape). The other layout, a thread a pixel looping over its
// channels with the same vectors and storing them itself, was built and timed
// in turns against this one on an H100 (CUDA graphs, (32, 256, 256, 6)): 1.4x
// slower in float32, 6 % faster in bfloat16, and 3.3x slower at (32, 64, 64,
// 64) float32, where a warp's stores are 256 bytes apart; staging its outputs
// in shared memory for contiguous stores would need 256 x C elements (300 KB
// at C = 300). Unrolling this kernel's loop over vectors (2 or 4 in flight a
// thread) did not make it faster.
//
// tfcgan_gridsample_bwd: threads over (pixel, channel) with channels fastest,
// as the forward's, so the reads of g are coalesced and, for a smooth flow, the
// atomics of one warp to one tap land on a few contiguous L2 sectors (a
// thread a pixel looping over the channels would put its lanes' addresses
// 4 * C bytes apart: about 24 sectors a warp at C = 6 where 4 do). A
// block owns whole pixels, whose taps its first threads compute once, exactly
// as the forward does, into shared memory (a tap a channel thread would cost
// C times the coordinate arithmetic). Each thread adds w * g into the float32
// image gradient with atomicAdd (any number of output pixels may sample one
// input pixel, so no gather form exists for an arbitrary flow; the order of
// those additions changes from run to run and with it the last bits of the
// image gradient), and leaves its channel's share of the two coordinate
// gradients in shared memory; the pixel's first thread sums the shares in
// channel order and writes them once (one writer, one order: the grid
// gradient repeats bit for bit). The image gradient is zeroed here, on the
// same stream, before the kernel. Either result is skipped when its pointer
// is null.
//
// Coordinates are computed with unfused, individually rounded operations in
// the order of the plain tensor code (ops/warp.py): a sample that sits on an
// integer coordinate (the identity grid does, everywhere) must floor to the
// same pixel in both, because the coordinate gradient is the forward
// difference on one side of an integer and the backward difference on the
// other. Coordinates that no int holds (1e10, inf, NaN) are clamped to
// [-1, size] before the cast: under zeros such a sample is 0 with no gradient,
// under border it reads the edge pixel it was clamped to (NaN: pixel 0), and
// no tap ever addresses memory outside the image.
//
// What bounds the backward: bytes (it reads g, inp and grid and writes both
// gradients) and its atomics (4 an output element), which go to L2 and are
// what it waits for: the (pixel, channel) threads make them coalesce.
//
// Left for later work: a deterministic image gradient. Tried on the card and
// not kept: accumulating the image gradient of a block's 8 x 32
// output pixels in a shared-memory window of the input before one atomic an
// element goes to L2 (3.4 times fewer atomics to L2 at the path's flow, and
// slower: the shared atomics, the window's zeroing and flush and the
// registers they cost outweighed what L2 saved, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// padding codes; 1 is border, which needs no branch: its taps are only clamped
constexpr int kZeros = 0;
constexpr int kReflection = 2;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// One axis of one sample: its two taps, their weights, and the derivative of
// the pixel coordinate with respect to the normalized one.
struct Axis {
  int i0, i1;    // tap indices, always inside [0, size)
  float w0, w1;  // 1 - t and t
  bool on0, on1; // false: the tap lies off the image under zeros padding and reads 0
  float scale;   // d(pixel coordinate) / d(grid coordinate), 0 where the fold is flat
};

__device__ __forceinline__ Axis axis_taps(float g, int size, int padding, int align) {
  const float fsize = static_cast<float>(size);
  const float last = static_cast<float>(size - 1);
  // unnormalize, every operation rounded on its own, in the plain version's order
  const float g1 = __fadd_rn(g, 1.f);
  float x = align ? __fmul_rn(__fmul_rn(g1, 0.5f), last)
                  : __fmul_rn(__fsub_rn(__fmul_rn(g1, fsize), 1.f), 0.5f);
  float scale = align ? 0.5f * last : 0.5f * fsize;
  if (padding == kReflection) {
    // reflect into [lo, lo + span], then clip to the pixel centres
    const float lo = align ? 0.f : -0.5f;
    const float span = align ? last : fsize;
    if (span <= 0.f) {
      x = lo;
      scale = 0.f;
    } else {
      const float d = __fsub_rn(x, lo);
      float sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
      float r = fmodf(fabsf(d), 2.f * span);
      if (r > span) {
        r = __fsub_rn(2.f * span, r);
        sign = -sign;
      }
      x = __fadd_rn(r, lo);
      scale *= sign;
    }
    if (!(x >= 0.f && x <= last)) scale = 0.f;  // clipped (or NaN): flat
    x = fminf(fmaxf(x, 0.f), last);             // NaN goes to 0
  }
  // [-1, size] holds every coordinate with a tap on the image; beyond it the
  // taps are all off the image (zeros) or both clamp to one edge pixel (border)
  const bool inside = x >= -1.f && x <= fsize;  // false for NaN
  const float xc = fminf(fmaxf(x, -1.f), fsize);
  const float f = floorf(xc);
  const float t = __fsub_rn(xc, f);
  const int i0 = static_cast<int>(f);
  const int i1 = i0 + 1;
  Axis a;
  a.w0 = __fsub_rn(1.f, t);
  a.w1 = t;
  const bool zeros = padding == kZeros;
  a.on0 = !zeros || (inside && i0 >= 0 && i0 < size);
  a.on1 = !zeros || (inside && i1 >= 0 && i1 < size);
  a.i0 = min(max(i0, 0), size - 1);
  a.i1 = min(max(i1, 0), size - 1);
  a.scale = scale;
  return a;
}

// V consecutive elements of T as one aligned access of V * sizeof(T) bytes
// (2 to 16), converted to or from float32.
template <int Bytes> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  using W = typename Word<sizeof(T) * V>::type;
  if constexpr (sizeof(T) == 4) {
    union { W w; float f[V]; } u;
    u.w = *reinterpret_cast<const W*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = u.f[i];
  } else {  // bfloat16: the high half of a float32
    union { W w; unsigned short b[V]; } u;
    u.w = *reinterpret_cast<const W*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __uint_as_float(static_cast<unsigned int>(u.b[i]) << 16);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using W = typename Word<sizeof(T) * V>::type;
  if constexpr (sizeof(T) == 4) {
    union { W w; float f[V]; } u;
#pragma unroll
    for (int i = 0; i < V; ++i) u.f[i] = v[i];
    *reinterpret_cast<W*>(p) = u.w;
  } else {
    union { W w; unsigned short b[V]; } u;
#pragma unroll
    for (int i = 0; i < V; ++i) u.b[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
    *reinterpret_cast<W*>(p) = u.w;
  }
}

// A block owns kThreads consecutive output pixels. Its thread t first works
// out pixel p0 + t's taps into shared memory: the element offsets of taps 00,
// 01, 10, 11 (y, x) into inp, -1 for a tap that reads 0, and their weights.
// Then the block's threads walk its contiguous output, pixels x C channels, V
// channels a step. grid_pairs: the grid is 8-byte aligned (one float2 load a
// pixel). Every offset into inp fits an int (the caller checks inp's size),
// and so does every pixel index.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gridsample_fwd_kernel(const T* __restrict__ inp, const float* __restrict__ grid,
                      T* __restrict__ out, int pixels, int plane, int h, int w, int c,
                      int padding, int align, int grid_pairs) {
  __shared__ int4 offs[kThreads];
  __shared__ float4 wts[kThreads];
  const int p0 = blockIdx.x * kThreads;
  const int count = min(kThreads, pixels - p0);
  if (static_cast<int>(threadIdx.x) < count) {
    const int pix = p0 + threadIdx.x;
    float gx, gy;
    if (grid_pairs) {
      const float2 g = reinterpret_cast<const float2*>(grid)[pix];
      gx = g.x;
      gy = g.y;
    } else {
      gx = grid[2 * static_cast<int64_t>(pix)];
      gy = grid[2 * static_cast<int64_t>(pix) + 1];
    }
    const Axis ax = axis_taps(gx, w, padding, align);
    const Axis ay = axis_taps(gy, h, padding, align);
    const int base = pix / plane * h * w * c;
    const int r0 = ay.i0 * w, r1 = ay.i1 * w;
    offs[threadIdx.x] = make_int4(ay.on0 && ax.on0 ? base + (r0 + ax.i0) * c : -1,
                                  ay.on0 && ax.on1 ? base + (r0 + ax.i1) * c : -1,
                                  ay.on1 && ax.on0 ? base + (r1 + ax.i0) * c : -1,
                                  ay.on1 && ax.on1 ? base + (r1 + ax.i1) * c : -1);
    wts[threadIdx.x] = make_float4(__fmul_rn(ax.w0, ay.w0), __fmul_rn(ax.w1, ay.w0),
                                   __fmul_rn(ax.w0, ay.w1), __fmul_rn(ax.w1, ay.w1));
  }
  __syncthreads();
  const int vectors = c / V;  // a pixel's
  T* dst = out + static_cast<int64_t>(p0) * c;
  for (int i = threadIdx.x; i < count * vectors; i += kThreads) {
    const int lp = i / vectors;
    const int ch = (i - lp * vectors) * V;
    const int4 o = offs[lp];
    const float4 wt = wts[lp];
    float v00[V], v01[V], v10[V], v11[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v00[k] = v01[k] = v10[k] = v11[k] = 0.f;
    if (o.x >= 0) load_vec<T, V>(inp + o.x + ch, v00);
    if (o.y >= 0) load_vec<T, V>(inp + o.y + ch, v01);
    if (o.z >= 0) load_vec<T, V>(inp + o.z + ch, v10);
    if (o.w >= 0) load_vec<T, V>(inp + o.w + ch, v11);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {  // the plain version's sum, term by term
      acc[k] = __fmul_rn(v00[k], wt.x);
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v01[k], wt.y));
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v10[k], wt.z));
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v11[k], wt.w));
    }
    store_vec<T, V>(dst + static_cast<int64_t>(i) * V, acc);
  }
}

// What the threads of one pixel share in the backward: its four taps (element
// offsets into inp, -1 for a tap that reads 0), their weights, the axis
// weights of the coordinate gradients and the two coordinate scales.
struct PixelTaps {
  int o[4];  // taps 00, 01, 10, 11 (y, x)
  float w[4];
  float xw0, xw1, yw0, yw1, sx, sy;
};

// Threads over (pixel, channel), channels fastest, as the forward's; a block
// owns `ppb` whole pixels, cw = min(c, kThreads) threads a pixel, the thread
// ch0 of a pixel over channels ch0, ch0 + cw, ... . The first ppb threads
// compute the pixels' taps once, into shared memory. dinp and dgrid may each
// be null (the same for every thread of the launch). Every offset into inp
// fits an int (the caller checks inp's size), and so does every pixel index.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gridsample_bwd_kernel(const T* __restrict__ g, const T* __restrict__ inp,
                      const float* __restrict__ grid, float* __restrict__ dinp,
                      float* __restrict__ dgrid, int pixels, int plane, int h, int w, int c,
                      int cw, int ppb, int padding, int align) {
  __shared__ PixelTaps taps[kThreads];
  __shared__ float2 part[kThreads];  // each thread's share of its pixel's (gx, gy)
  const int p0 = blockIdx.x * ppb;
  if (threadIdx.x < ppb && p0 + static_cast<int>(threadIdx.x) < pixels) {
    const int pix = p0 + threadIdx.x;
    const Axis ax = axis_taps(grid[2 * static_cast<int64_t>(pix)], w, padding, align);
    const Axis ay = axis_taps(grid[2 * static_cast<int64_t>(pix) + 1], h, padding, align);
    const int base = pix / plane * h * w * c;
    const int r0 = ay.i0 * w, r1 = ay.i1 * w;
    PixelTaps t;
    t.o[0] = ay.on0 && ax.on0 ? base + (r0 + ax.i0) * c : -1;
    t.o[1] = ay.on0 && ax.on1 ? base + (r0 + ax.i1) * c : -1;
    t.o[2] = ay.on1 && ax.on0 ? base + (r1 + ax.i0) * c : -1;
    t.o[3] = ay.on1 && ax.on1 ? base + (r1 + ax.i1) * c : -1;
    t.w[0] = ax.w0 * ay.w0;
    t.w[1] = ax.w1 * ay.w0;
    t.w[2] = ax.w0 * ay.w1;
    t.w[3] = ax.w1 * ay.w1;
    t.xw0 = ax.w0;
    t.xw1 = ax.w1;
    t.yw0 = ay.w0;
    t.yw1 = ay.w1;
    t.sx = ax.scale;
    t.sy = ay.scale;
    taps[threadIdx.x] = t;
  }
  __syncthreads();
  const int lp = threadIdx.x / cw, ch0 = threadIdx.x % cw;
  const int pix = p0 + lp;
  const bool live = lp < ppb && pix < pixels;
  float gx = 0.f, gy = 0.f;
  if (live) {
    const PixelTaps& t = taps[lp];
    const T* gp = g + static_cast<int64_t>(pix) * c;
    for (int ch = ch0; ch < c; ch += cw) {
      const float gv = load_f32(gp + ch);
      if (dinp != nullptr) {
        // the lanes of a warp add into neighbouring channels of neighbouring
        // pixels: for a smooth flow, a few contiguous L2 sectors a tap
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (t.o[i] >= 0) atomicAdd(dinp + t.o[i] + ch, gv * t.w[i]);
        }
      }
      if (dgrid != nullptr) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = t.o[i] >= 0 ? load_f32(inp + t.o[i] + ch) : 0.f;
        // d out / d tx and d out / d ty: a pair of taps clamped to one pixel
        // cancels, a tap off the image counts as 0
        gx += gv * ((v[1] - v[0]) * t.yw0 + (v[3] - v[2]) * t.yw1);
        gy += gv * ((v[2] - v[0]) * t.xw0 + (v[3] - v[1]) * t.xw1);
      }
    }
  }
  if (dgrid == nullptr) return;
  // the pixel's channel shares summed by its first thread in channel order:
  // one writer, one order, the same bits every run
  part[threadIdx.x] = make_float2(gx, gy);
  __syncthreads();
  if (live && ch0 == 0) {
    float tx = 0.f, ty = 0.f;
    for (int i = 0; i < cw; ++i) {
      const float2 v = part[threadIdx.x + i];
      tx += v.x;
      ty += v.y;
    }
    dgrid[2 * static_cast<int64_t>(pix)] = tx * taps[lp].sx;
    dgrid[2 * static_cast<int64_t>(pix) + 1] = ty * taps[lp].sy;
  }
}

template <typename T, int V>
void launch_fwd_as(const void* inp, const float* grid, void* out, int pixels, int plane, int h,
                   int w, int c, int padding, int align, int grid_pairs, cudaStream_t s) {
  const auto blocks = static_cast<unsigned int>((pixels + kThreads - 1) / kThreads);
  gridsample_fwd_kernel<T, V><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(inp), grid, static_cast<T*>(out), pixels, plane, h, w, c, padding,
      align, grid_pairs);
}

// V: the widest vector of up to 16 bytes that divides C and to which inp and
// out are aligned.
template <typename T>
void launch_fwd(const void* inp, const float* grid, void* out, int pixels, int plane, int h,
                int w, int c, int padding, int align, int grid_pairs, cudaStream_t s) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(inp) | reinterpret_cast<uintptr_t>(out);
  const auto fits = [&](int v) { return c % v == 0 && at % (v * sizeof(T)) == 0; };
  if (sizeof(T) == 2 && fits(8)) {
    launch_fwd_as<T, 16 / sizeof(T)>(inp, grid, out, pixels, plane, h, w, c, padding, align,
                                     grid_pairs, s);
  } else if (fits(4)) {
    launch_fwd_as<T, 4>(inp, grid, out, pixels, plane, h, w, c, padding, align, grid_pairs, s);
  } else if (fits(2)) {
    launch_fwd_as<T, 2>(inp, grid, out, pixels, plane, h, w, c, padding, align, grid_pairs, s);
  } else {
    launch_fwd_as<T, 1>(inp, grid, out, pixels, plane, h, w, c, padding, align, grid_pairs, s);
  }
}

}  // namespace

// Both take contiguous tensors on the current device and return
// cudaGetLastError(). The caller checks: every size >= 1, n * h * w * c and
// n * hg * wg below 2^31, n * hg * wg * c below 2^31 * 256, 256 * c below
// 2^31, padding in {0 zeros, 1 border, 2 reflection}.
// dtype: 0 = float32, 1 = bfloat16 (of inp, out and g); grid, dinp and dgrid
// are float32.

extern "C" int tfcgan_gridsample_fwd(const void* inp, const float* grid, void* out, int n, int h,
                                     int w, int c, int hg, int wg, int padding, int align,
                                     int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int plane = hg * wg, pixels = n * plane;
  const int pairs = reinterpret_cast<uintptr_t>(grid) % 8 == 0;
  if (dtype == 0) {
    launch_fwd<float>(inp, grid, out, pixels, plane, h, w, c, padding, align, pairs, s);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(inp, grid, out, pixels, plane, h, w, c, padding, align, pairs, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dinp (N, H, W, C) float32, zeroed here, gets the image gradient; dgrid
// (N, Hg, Wg, 2) the grid gradient. A null pointer skips that result.
extern "C" int tfcgan_gridsample_bwd(const void* g, const void* inp, const float* grid,
                                     float* dinp, float* dgrid, int n, int h, int w, int c,
                                     int hg, int wg, int padding, int align, int dtype,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(hg) * wg;
  const int64_t pixels = static_cast<int64_t>(n) * plane;
  if (dinp != nullptr) {
    const size_t bytes = static_cast<size_t>(n) * h * w * c * sizeof(float);
    const cudaError_t err = cudaMemsetAsync(dinp, 0, bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int cw = c < kThreads ? c : kThreads;  // threads a pixel
  const int ppb = kThreads / cw;                 // whole pixels a block
  const auto blocks = static_cast<unsigned int>((pixels + ppb - 1) / ppb);
  const int pix = static_cast<int>(pixels), pl = static_cast<int>(plane);
  if (dtype == 0) {
    gridsample_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(inp), grid, dinp, dgrid, pix, pl,
        h, w, c, cw, ppb, padding, align);
  } else if (dtype == 1) {
    gridsample_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(inp), grid, dinp,
        dgrid, pix, pl, h, w, c, cw, ppb, padding, align);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
