// Blur-pool forward and backward for Hopper (sm_90a):
// antialiased_cnns.BlurPool(filt_size=4) on NHWC tensors, float32 or bfloat16
// in and out, float32 accumulation.
//
//   y[n, o, q, c] = sum_{a,b} k[a] k[b] x[n, reflect(s*o + a - 1, H), reflect(s*q + b - 1, W), c]
//   k = [1, 3, 3, 1] / 8,  s = 1 or 2,  Ho = (H - 1) / s + 1,  Wo = (W - 1) / s + 1
//
// Forward: replaces the TPU kernel tfcgan_tpu/ops/pallas_kernels/blurpool.py
// (_fwd_kernel, reached through blur_pool_fast). That kernel tiles rows into
// VMEM, gathers reflect halos in XLA and splits parities by reshapes because
// Mosaic rejects strided slices; none of that has a reason here. Each thread
// computes one output element with the reflect indices worked out in the
// kernel, so no padded copy of x is ever written.
//
// Backward: replaces _bwd_kernel / _blur_pool_bwd_impl / _bp_bwd of the same
// module (row tiles, XLA-gathered halo rows, the W adjoint as an XLA einsum on
// thin rows, extra folds for odd lengths). Here it is the exact adjoint in
// gather form, one thread per dx element, written from the math: along an
// axis of input length n and output length no, dx[r] collects k[a] * dy[o]
// for every (o, a) with reflect(s*o + a - 1, n) == r. The reads s*o + a - 1
// lie in [-1, n + 1]; the ones outside [0, n) fold back onto r = 1, n - 2 and
// n - 3 (or onto any r for n <= 3), and every such o lies in the window
// [ceil((r - 2) / s), floor((r + 3) / s)] clipped to [0, no): at most 6
// outputs at stride 1 and 3 at stride 2. The 2-D adjoint is the product of
// the two axes' weights over those windows. Away from the borders (all but
// the 2 first and 3 last rows and columns) the window is known: 4 outputs
// with the taps reversed at stride 1, 2 at stride 2, so the thread reads 16 or
// 4 dy values with constant weights; only border threads build the windows.
// (Building them in every thread bound a first version by integer work, at
// 6-7x the forward's time for the same bytes.) No atomics: every dx element
// is written once by one thread, so the result is deterministic.
//
// What bounds both: bytes. The forward reads X and writes X/4 (stride 2) or
// X (stride 1); the backward reads dy and writes dx, with dx 4x dy at stride
// 2. Channels are the fastest index of both the thread and the tensor, so a
// warp reads 32 neighbouring channels of one pixel per tap (coalesced), and
// the tap reuse between neighbouring threads is served by L1/L2 rather than
// by device memory.
//
// Left for later work: tiling rows through shared memory, 16-byte vector
// loads over channels, and fusing the blur into the neighbouring instance
// norm (forward) or its gradient (backward).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Reflection without repeating the edge sample (torch ReflectionPad2d, numpy
// "reflect"), generic for every n >= 1 and any integer j: the same mapping as
// _reflect in the TPU kernel's module. The in-range test is only a shortcut.
__device__ __forceinline__ int reflect_index(int j, int n) {
  if (j >= 0 && j < n) return j;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  j %= period;
  if (j < 0) j += period;
  return j < n ? j : period - j;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grid.x: one block row per output row (n, o); grid.y: chunks of Wo*C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
blurpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c,
                    int ho, int wo, int stride) {
  const int q = blockIdx.y * kThreads + threadIdx.x;  // index in the output row: ow * c + ci
  if (q >= wo * c) return;
  const int64_t row = blockIdx.x;                      // n * ho + oh
  const int64_t n = row / ho;
  const int oh = static_cast<int>(row - n * ho);
  const int ow = q / c;
  const int ci = q - ow * c;

  const float k[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int64_t row_stride = static_cast<int64_t>(w) * c;
  const T* xn = x + n * static_cast<int64_t>(h) * row_stride + ci;

  int col_off[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) col_off[b] = reflect_index(stride * ow + b - 1, w) * c;

  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T* xr = xn + reflect_index(stride * oh + a - 1, h) * row_stride;
    float r = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) r = fmaf(k[b], load_f32(xr + col_off[b]), r);
    acc = fmaf(k[a], r, acc);
  }
  store_f32(y + row * static_cast<int64_t>(wo) * c + q, acc);
}

template <typename T>
void launch(const void* x, void* y, int64_t n, int h, int w, int c, int ho, int wo,
            int stride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n * ho),
                  static_cast<unsigned>((static_cast<int64_t>(wo) * c + kThreads - 1) / kThreads));
  blurpool_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w, c, ho, wo, stride);
}

// The forward tap weight k[a] for a read at offset a of a window, 0 outside it.
__device__ __forceinline__ float tap_weight(int a) {
  return static_cast<unsigned>(a) < 4u ? ((a == 0 || a == 3) ? 0.125f : 0.375f) : 0.f;
}

constexpr int kWindow = 6;      // outputs that can read one input: 6 at stride 1, 3 at stride 2
constexpr int kNoRead = -(1 << 20);  // a read position that no window reaches

// Adjoint weights of one axis for input index r: wt[i] is the summed weight
// with which output o_lo + i reads r. Output o reads j = S*o + a - 1 with tap
// a, so the read of r itself has a = r + 1 - S*o; the reads outside [0, n)
// that reflect onto r (j = -1, n, n + 1) add theirs. Returns o_lo.
template <int S>
__device__ __forceinline__ int adjoint_weights(int r, int n, int no, float (&wt)[kWindow]) {
  const int o_lo = r < 2 ? 0 : (r - 2 + S - 1) / S;
  const int o_hi = min(no - 1, (r + 3) / S);
  // reflect_index(-1, n), (n, n) and (n + 1, n) in closed form
  const int fold_lo = (n == 1 ? 0 : 1) == r ? -1 : kNoRead;
  const int fold_n = (n == 1 ? 0 : n - 2) == r ? n : kNoRead;
  const int fold_n1 = (n == 1 ? 0 : n == 2 ? 1 : n - 3) == r ? n + 1 : kNoRead;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    const int base = 1 - S * (o_lo + i);  // a = j + base for a read at j
    wt[i] = o_lo + i <= o_hi ? tap_weight(r + base) + tap_weight(fold_lo + base) +
                                   tap_weight(fold_n + base) + tap_weight(fold_n1 + base)
                             : 0.f;
  }
  return o_lo;
}

// grid.x: one block row per dx row (n, r); grid.y: chunks of W*C.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
blurpool_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int h, int w, int c,
                    int ho, int wo) {
  const int q = blockIdx.y * kThreads + threadIdx.x;  // index in the dx row: iw * c + ci
  if (q >= w * c) return;
  const int row = blockIdx.x;                          // n * h + r (< 2^31: 32-bit division)
  const int n = row / h;
  const int r = row - n * h;
  const int iw = q / c;
  const int ci = q - iw * c;
  const int64_t row_stride = static_cast<int64_t>(wo) * c;
  const T* dyn = dy + static_cast<int64_t>(n) * ho * row_stride + ci;

  float acc = 0.f;
  if (r >= 2 && r <= h - 4 && iw >= 2 && iw <= w - 4) {
    // interior (all but the 2 first and 3 last rows and columns): no
    // reflected read lands here, and the outputs reading (r, iw) are those
    // with S*o = r + 1 - a for a tap a: 4 consecutive at stride 1, 2 at stride 2
    constexpr int kTaps = S == 1 ? 4 : 2;
    float wr[kTaps], wc[kTaps];
    if constexpr (S == 1) {  // taps a = 3, 2, 1, 0 of outputs r - 2 .. r + 1
      const float k[kTaps] = {0.125f, 0.375f, 0.375f, 0.125f};
#pragma unroll
      for (int i = 0; i < kTaps; ++i) wr[i] = wc[i] = k[i];
    } else {  // even r: taps 3, 1 of outputs r/2 - 1, r/2; odd r: 2, 0 of (r-1)/2, (r+1)/2
      wr[0] = r & 1 ? 0.375f : 0.125f, wr[1] = r & 1 ? 0.125f : 0.375f;
      wc[0] = iw & 1 ? 0.375f : 0.125f, wc[1] = iw & 1 ? 0.125f : 0.375f;
    }
    const int o0 = S == 1 ? r - 2 : (r - 1) >> 1;
    const int p0 = S == 1 ? iw - 2 : (iw - 1) >> 1;
    const T* dyr = dyn + o0 * row_stride + static_cast<int64_t>(p0) * c;
#pragma unroll
    for (int i = 0; i < kTaps; ++i, dyr += row_stride) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) sum = fmaf(wc[j], load_f32(dyr + j * c), sum);
      acc = fmaf(wr[i], sum, acc);
    }
  } else {
    float wr[kWindow], wc[kWindow];
    const int o_lo = adjoint_weights<S>(r, h, ho, wr);
    const int p_lo = adjoint_weights<S>(iw, w, wo, wc);
    const T* dyr = dyn + o_lo * row_stride + static_cast<int64_t>(p_lo) * c;
#pragma unroll
    for (int i = 0; i < kWindow; ++i, dyr += row_stride) {
      if (wr[i] == 0.f) continue;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        if (wc[j] != 0.f) sum = fmaf(wc[j], load_f32(dyr + j * c), sum);
      }
      acc = fmaf(wr[i], sum, acc);
    }
  }
  store_f32(dx + static_cast<int64_t>(row) * w * c + q, acc);
}

template <typename T>
void launch_bwd(const void* dy, void* dx, int64_t n, int h, int w, int c, int ho, int wo,
                int stride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n * h),
                  static_cast<unsigned>((static_cast<int64_t>(w) * c + kThreads - 1) / kThreads));
  const T* src = static_cast<const T*>(dy);
  T* dst = static_cast<T*>(dx);
  if (stride == 1) {
    blurpool_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(src, dst, h, w, c, ho, wo);
  } else {
    blurpool_bwd_kernel<T, 2><<<grid, kThreads, 0, stream>>>(src, dst, h, w, c, ho, wo);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (n, h, w, c) and y (n, ho, wo, c),
// both contiguous on the current device; the caller checks shapes and the
// grid limits (n * ho < 2^31, wo * c < 2^31). Returns cudaGetLastError().
extern "C" int tfcgan_blurpool_fwd(const void* x, void* y, int64_t n, int h, int w, int c,
                                   int ho, int wo, int stride, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, n, h, w, c, ho, wo, stride, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, n, h, w, c, ho, wo, stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The adjoint of tfcgan_blurpool_fwd: dy is (n, ho, wo, c) and dx (n, h, w, c),
// both contiguous on the current device, ho/wo the forward's output lengths
// for h/w at this stride; the caller checks shapes and the grid limits
// (n * h < 2^31, w * c < 2^31). Returns cudaGetLastError().
extern "C" int tfcgan_blurpool_bwd(const void* dy, void* dx, int64_t n, int h, int w, int c,
                                   int ho, int wo, int stride, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_bwd<float>(dy, dx, n, h, w, c, ho, wo, stride, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(dy, dx, n, h, w, c, ho, wo, stride, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
