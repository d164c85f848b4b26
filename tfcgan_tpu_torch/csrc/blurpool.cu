// Blur-pool forward for Hopper (sm_90a): antialiased_cnns.BlurPool(filt_size=4)
// on NHWC tensors, float32 or bfloat16 in and out, float32 accumulation.
//
//   y[n, o, q, c] = sum_{a,b} k[a] k[b] x[n, reflect(s*o + a - 1, H), reflect(s*q + b - 1, W), c]
//   k = [1, 3, 3, 1] / 8,  s = 1 or 2,  Ho = (H - 1) / s + 1,  Wo = (W - 1) / s + 1
//
// Replaces the TPU kernel tfcgan_tpu/ops/pallas_kernels/blurpool.py
// (_fwd_kernel, reached through blur_pool_fast). That kernel tiles rows into
// VMEM, gathers reflect halos in XLA and splits parities by reshapes because
// Mosaic rejects strided slices; none of that has a reason here. Each thread
// computes one output element with the reflect indices worked out in the
// kernel, so no padded copy of x is ever written.
//
// What bounds it: bytes. Each output reads 16 inputs and does 16 FMAs; at
// stride 2 the kernel must read X and write X/4, at stride 1 read X and write
// X. Channels are the fastest index of both the thread and the tensor, so a
// warp reads 32 neighbouring channels of one pixel per tap (coalesced), and
// the 4x (stride 2) or 16x (stride 1) tap reuse between neighbouring outputs
// is served by L1/L2 rather than by device memory.
//
// Left for later work: tiling rows through shared memory, 16-byte vector
// loads over channels, and fusing the blur into the neighbouring instance
// norm. The backward (the exact adjoint) comes with the training slice.

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
