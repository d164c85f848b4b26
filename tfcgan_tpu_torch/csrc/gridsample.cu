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
// tfcgan_gridsample_fwd: one thread per output element, channels fastest, so
// a warp writes neighbouring addresses and, for a smooth flow, reads
// neighbouring pixels; the threads of one pixel read the same two grid values
// (one broadcast load each). float32 arithmetic, output in inp's dtype.
//
// tfcgan_gridsample_bwd: one thread per output pixel, looping over the
// channels. It recomputes the taps exactly as the forward does, sums the two
// coordinate gradients over the channels in registers and writes them once
// (one writer per element), and adds w * g into the float32 image gradient
// with atomicAdd: any number of output pixels may sample one input pixel, so
// no gather form exists for an arbitrary flow. The order of those additions
// changes from run to run and with it the last bits of the image gradient.
// The image gradient is zeroed here, on the same stream, before the kernel.
// Either result is skipped when its pointer is null.
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
// What bounds both: bytes. The forward reads inp and grid once and writes out;
// the backward reads g, inp and grid and writes both gradients. The 4 taps of
// neighbouring outputs overlap and are served by L1/L2. The backward's atomics
// go to L2 and are what it waits for.
//
// Left for later work: 16-byte loads, merging the atomics of neighbouring
// pixels in shared memory before they go to L2, a deterministic variant.

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
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
__device__ __forceinline__ float tap(const T* p, bool on) {
  return on ? load_f32(p) : 0.f;
}

// One thread per output element e = pixel * c + channel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gridsample_fwd_kernel(const T* __restrict__ inp, const float* __restrict__ grid,
                      T* __restrict__ out, int64_t total, int64_t plane, int h, int w, int c,
                      int padding, int align) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t pix = e / c;
  const int ch = static_cast<int>(e - pix * c);
  const int64_t n = pix / plane;
  const Axis ax = axis_taps(grid[2 * pix], w, padding, align);
  const Axis ay = axis_taps(grid[2 * pix + 1], h, padding, align);
  const T* img = inp + n * h * w * c + ch;
  const int64_t r0 = static_cast<int64_t>(ay.i0) * w, r1 = static_cast<int64_t>(ay.i1) * w;
  const float v00 = tap(img + (r0 + ax.i0) * c, ay.on0 && ax.on0);
  const float v01 = tap(img + (r0 + ax.i1) * c, ay.on0 && ax.on1);
  const float v10 = tap(img + (r1 + ax.i0) * c, ay.on1 && ax.on0);
  const float v11 = tap(img + (r1 + ax.i1) * c, ay.on1 && ax.on1);
  // the plain version's sum, term by term
  float acc = __fmul_rn(v00, __fmul_rn(ax.w0, ay.w0));
  acc = __fadd_rn(acc, __fmul_rn(v01, __fmul_rn(ax.w1, ay.w0)));
  acc = __fadd_rn(acc, __fmul_rn(v10, __fmul_rn(ax.w0, ay.w1)));
  acc = __fadd_rn(acc, __fmul_rn(v11, __fmul_rn(ax.w1, ay.w1)));
  store_f32(out + e, acc);
}

// One thread per output pixel; dinp and dgrid may each be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gridsample_bwd_kernel(const T* __restrict__ g, const T* __restrict__ inp,
                      const float* __restrict__ grid, float* __restrict__ dinp,
                      float* __restrict__ dgrid, int64_t pixels, int64_t plane, int h, int w,
                      int c, int padding, int align) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= pixels) return;
  const int64_t n = pix / plane;
  const Axis ax = axis_taps(grid[2 * pix], w, padding, align);
  const Axis ay = axis_taps(grid[2 * pix + 1], h, padding, align);
  const int64_t base = n * h * w * c;
  const int64_t r0 = static_cast<int64_t>(ay.i0) * w, r1 = static_cast<int64_t>(ay.i1) * w;
  const int64_t o00 = base + (r0 + ax.i0) * c, o01 = base + (r0 + ax.i1) * c;
  const int64_t o10 = base + (r1 + ax.i0) * c, o11 = base + (r1 + ax.i1) * c;
  const bool on00 = ay.on0 && ax.on0, on01 = ay.on0 && ax.on1;
  const bool on10 = ay.on1 && ax.on0, on11 = ay.on1 && ax.on1;
  const float w00 = ax.w0 * ay.w0, w01 = ax.w1 * ay.w0;
  const float w10 = ax.w0 * ay.w1, w11 = ax.w1 * ay.w1;
  const T* gp = g + pix * c;
  float gx = 0.f, gy = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = load_f32(gp + ch);
    if (dinp != nullptr) {
      if (on00) atomicAdd(dinp + o00 + ch, gv * w00);
      if (on01) atomicAdd(dinp + o01 + ch, gv * w01);
      if (on10) atomicAdd(dinp + o10 + ch, gv * w10);
      if (on11) atomicAdd(dinp + o11 + ch, gv * w11);
    }
    if (dgrid != nullptr) {
      const float v00 = tap(inp + o00 + ch, on00), v01 = tap(inp + o01 + ch, on01);
      const float v10 = tap(inp + o10 + ch, on10), v11 = tap(inp + o11 + ch, on11);
      // d out / d tx and d out / d ty: a pair of taps clamped to one pixel
      // cancels, a tap off the image counts as 0
      gx += gv * ((v01 - v00) * ay.w0 + (v11 - v10) * ay.w1);
      gy += gv * ((v10 - v00) * ax.w0 + (v11 - v01) * ax.w1);
    }
  }
  if (dgrid != nullptr) {
    dgrid[2 * pix] = gx * ax.scale;
    dgrid[2 * pix + 1] = gy * ay.scale;
  }
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Both take contiguous tensors on the current device and return
// cudaGetLastError(). The caller checks: every size >= 1, n * hg * wg * c
// below 2^31 * 256, padding in {0 zeros, 1 border, 2 reflection}.
// dtype: 0 = float32, 1 = bfloat16 (of inp, out and g); grid, dinp and dgrid
// are float32.

extern "C" int tfcgan_gridsample_fwd(const void* inp, const float* grid, void* out, int n, int h,
                                     int w, int c, int hg, int wg, int padding, int align,
                                     int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t plane = static_cast<int64_t>(hg) * wg;
  const int64_t total = static_cast<int64_t>(n) * plane * c;
  const unsigned int blocks = blocks_for(total);
  if (dtype == 0) {
    gridsample_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(inp), grid, static_cast<float*>(out), total, plane, h, w, c,
        padding, align);
  } else if (dtype == 1) {
    gridsample_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(inp), grid, static_cast<__nv_bfloat16*>(out), total,
        plane, h, w, c, padding, align);
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
  const unsigned int blocks = blocks_for(pixels);
  if (dtype == 0) {
    gridsample_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(inp), grid, dinp, dgrid, pixels,
        plane, h, w, c, padding, align);
  } else if (dtype == 1) {
    gridsample_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(inp), grid, dinp,
        dgrid, pixels, plane, h, w, c, padding, align);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
