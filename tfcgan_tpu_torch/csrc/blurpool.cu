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
// Mosaic rejects strided slices; none of that has a reason here. The reflect
// indices are worked out in the kernel, so no padded copy of x is ever
// written. What bounds it: bytes (it reads X and writes X/4 at stride 2, X at
// stride 1), once the loads are few enough. The first design, a thread an
// output element with 16 scalar 2- or 4-byte loads (each input loaded by 4
// threads at stride 2 and by 16 at stride 1), a reflect per tap and a 64-bit
// division per thread, was bound by load instructions instead: 22 % of the
// byte bound over the fft_glo step's calls. So a thread owns V consecutive
// channels (16 bytes: 8 in bfloat16, 4 in float32) of one output column in a
// strip of R = 4 output rows. It walks the strip's input rows once, in order
// (S * (R - 1) + 4 of them: 10 at stride 2, 7 at stride 1), sums each over
// the column's 4 window columns once (r: a chain of fmaf over the taps b, from
// 0) and adds r into every output row of the strip that reads it (acc: a
// chain of fmaf over the taps a, from 0). Those are the one-element kernel's
// operations in its order, so the results are bit for bit the same. An output
// row is stored as soon as its last input row is in, so only the rows still
// open hold registers (2 at stride 2, 4 at stride 1). A strip or column whose
// windows lie inside the image takes plain indices; the others reflect each
// index once (no modulo per tap). A block of threads is (channel vectors,
// columns), the channel vector fastest, over a grid of (row strips, column
// chunks, images), at most 65535 images a launch: no thread divides. The
// entry picks the access width per launch, as the backward's: V when C is a
// multiple of it and both pointers are aligned to it, else V = 1 (one scalar
// an access); every shape of the path takes V. Capped for 3 blocks of 256
// an SM, which ptxas allots 80 registers a thread: the 16-byte forms spill
// 20 bytes in bfloat16 and 12 in float32 at stride 2 (-Xptxas -v); the
// 64-register cap spilled up to 72 bytes in bfloat16.
//
// Variants timed against this design in turns by tools/kernel_turns.py on an
// NVIDIA H100 80GB HBM3 (700 W), as the 27 bf16 calls of an fft_glo B=128 step
// (bound 4.03 ms) and, on the device alone, the 11 calls of a B=8 G pass, all
// at the 64-register cap unless named; this design there: 5.32-5.54 ms and
// 0.099-0.100 ms. Strips of 2 rows at stride 2: 5.02-5.10 ms; of 2 rows at
// stride 1: no faster, 0.104 ms; of 8 rows: 6.04-6.06 ms, 0.120 ms; two output
// columns a thread (6 window columns for 2 where two threads load 8):
// 8.20-8.24 ms, 0.171 ms; 8-byte accesses at stride 1 for pixels of at most
// 256 bytes (the backward's choice): 5.56-5.59 ms against 5.31-5.35. At 128
// registers 4.96-5.15 ms and at the 3-block cap 4.94 ms against 5.48-5.56
// (0.097 ms against 0.101); strips of 2 rows at that cap 5.10 ms. Each variant
// was an edited copy of this file, timed with tools/kernel_turns.py --other.
//
// Backward: replaces _bwd_kernel / _blur_pool_bwd_impl / _bp_bwd of the same
// module (row tiles, XLA-gathered halo rows, the W adjoint as an XLA einsum on
// thin rows, extra folds for odd lengths). Here it is the exact adjoint in
// gather form, written from the math: along an axis of input length n and
// output length no, dx[r] collects k[a] * dy[o] for every (o, a) with
// reflect(s*o + a - 1, n) == r. The reads s*o + a - 1 lie in [-1, n + 1]; the
// ones outside [0, n) fold back onto r = 1, n - 2 and n - 3 (or onto any r for
// n <= 3), and every such o lies in the window [ceil((r - 2) / s),
// floor((r + 3) / s)] clipped to [0, no): at most 6 outputs at stride 1 and 3
// at stride 2. The 2-D adjoint is the product of the two axes' weights over
// those windows. No atomics: every dx element is written once by one thread,
// so the result is deterministic and repeats bit for bit.
//
// What bounds the backward: bytes (it reads dy and writes dx, 4x dy at stride
// 2), once the loads are few enough. A thread an element with 2- or 4-byte
// loads was bound instead by load instructions and L1 traffic: 4 loads an
// output at stride 2 and 16 at stride 1, most of them of dy values that the
// neighbouring threads read as well (10 % of the byte bound at the fft_glo
// step's shapes). So a thread owns V consecutive channels (16 bytes: 8 in
// bfloat16, 4 in float32; 8 bytes at stride 1 for pixels of at most 256
// bytes) of a 2 x 2 block of dx pixels, rows 2m, 2m + 1 and columns 2p,
// 2p + 1. Away from the borders (all but the 2 first and 3 last rows and
// columns) the windows are known: the block reads a 3 x 3 window of dy at
// stride 2 (9 vector loads for 4 x V outputs) and 5 x 5 at stride 1 (25 for
// 4 x V), sums each dy row over the columns once for both dx columns, and
// each column sum into both dx rows, in the order of the one-element form
// (column sums first, then the rows, each a chain of fmaf from 0). Border
// blocks build the general windows for each of their pixels and load every
// position of the window (clamped into dy) whatever its weight, so that no
// load waits behind a test of a weight: tested per position, the loads of a
// border pixel ran one after another, and the generator's 7 x 7 map, nearly
// all border, took longer than with a thread an element. A block of threads
// is (channel vectors, column pairs), the channel vector fastest, over a grid
// of (row pairs, column-pair chunks, images), at most 65535 images a launch:
// no thread divides. The entry picks the access width per launch: V when C
// is a multiple of V and both pointers are aligned to V elements, else the
// same kernel with V = 1 (one scalar an access). 64 registers a thread (4 blocks
// of 256 an SM); the 16-byte stride-1 form spills 224 bytes in bfloat16,
// which a cap of 80 registers (3 blocks) did not make faster.

// Row-edge form (the spatial mesh axis: an image's rows split over ranks).
// The x a kernel reads may be a window of a taller map: rows [row0, row0 +
// h) of a map of h_glob rows, and the y it writes the output rows [o_base,
// o_base + ho) of that map's h_glob-row output. Each output row reads the
// global rows its window names; where one leaves the map (the global top or
// bottom edge) it reflects as before, anywhere else it reads the halo rows
// that the caller put into the window, with no pad. The backward is the
// exact adjoint of the same form: dx covers the window's rows and collects
// only the window's outputs. Its grid walks global row pairs, so a window
// whose first row is odd keeps the stride-2 phase of the interior blocks.
// The whole map is the trivial window, row0 = 0, o_base = 0 and h_glob = h:
// every index, test and sum is then that of the form without windows, and
// the results are bit for bit its.

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

// The forward tap weight k[a] for a read at offset a of a window, 0 outside it.
__device__ __forceinline__ float tap_weight(int a) {
  return static_cast<unsigned>(a) < 4u ? ((a == 0 || a == 3) ? 0.125f : 0.375f) : 0.f;
}

// outputs that can read one input: 6 at stride 1, 3 at stride 2
template <int S> constexpr int kWindow = S == 1 ? 6 : 3;
constexpr int kNoRead = -(1 << 20);  // a read position that no window reaches

// Adjoint weights of one axis for input index r: wt[i] is the summed weight
// with which output o_lo + i reads r, over the outputs [o_first, o_last]
// that exist (the whole axis, or a row window's). Output o reads j = S*o +
// a - 1 with tap a, so the read of r itself has a = r + 1 - S*o; the reads
// outside [0, n) that reflect onto r (j = -1, n, n + 1) add theirs. Returns
// o_lo, which is inside [o_first, o_last] where any output reads r.
template <int S>
__device__ __forceinline__ int adjoint_weights(int r, int n, int o_first, int o_last,
                                               float (&wt)[kWindow<S>]) {
  const int o_lo = max(o_first, r < 2 ? 0 : (r - 2 + S - 1) / S);
  const int o_hi = min(o_last, (r + 3) / S);
  // reflect_index(-1, n), (n, n) and (n + 1, n) in closed form
  const int fold_lo = (n == 1 ? 0 : 1) == r ? -1 : kNoRead;
  const int fold_n = (n == 1 ? 0 : n - 2) == r ? n : kNoRead;
  const int fold_n1 = (n == 1 ? 0 : n == 2 ? 1 : n - 3) == r ? n + 1 : kNoRead;
#pragma unroll
  for (int i = 0; i < kWindow<S>; ++i) {
    const int base = 1 - S * (o_lo + i);  // a = j + base for a read at j
    wt[i] = o_lo + i <= o_hi ? tap_weight(r + base) + tap_weight(fold_lo + base) +
                                   tap_weight(fold_n + base) + tap_weight(fold_n1 + base)
                             : 0.f;
  }
  return o_lo;
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

// s = fmaf(k, v, first ? 0 : s), elementwise over a vector
template <int V>
__device__ __forceinline__ void fma_into(float (&s)[V], float k, const float (&v)[V], bool first) {
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = fmaf(k, v[i], first ? 0.f : s[i]);
}

// The forward's strip of output rows a thread, and the blocks of 256 threads
// an SM that its register cap allows (3: 80 registers a thread).
constexpr int kFwdRows = 4;
constexpr int kFwdMinBlocks = 3;

// Images lie on grid.z, at most this many a launch; more go in several.
constexpr int64_t kMaxImages = 65535;

// block (tx channel vectors, ty columns); grid (strips of R output rows,
// chunks of columns, images). A thread: V channels of output rows o0 .. o0 +
// R - 1 (those inside the map) of column q, for channel vectors threadIdx.x,
// threadIdx.x + tx, ... . x holds rows [row0, row0 + h) of an h_glob-row map
// and y its output rows [o_base, o_base + ho) (the row-edge form above).
template <typename T, int S, int V>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
blurpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c, int ho,
                    int wo, int h_glob, int row0, int o_base) {
  constexpr int R = kFwdRows;
  constexpr int kRows = S * (R - 1) + 4;  // the input rows of the strip's windows
  const float k[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int o0 = blockIdx.x * R;
  const int q = blockIdx.y * blockDim.y + threadIdx.y;
  if (q >= wo) return;
  // the windows' input rows (of x) and columns (times c), reflected where
  // they leave the map; the rows of a strip's outputs past ho, which are not
  // stored, are clamped into x
  const int j0 = S * (o_base + o0) - 1, b0 = S * q - 1;
  int rows[kRows], cols[4];
  if (j0 >= row0 && j0 + kRows <= row0 + h) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i] = j0 - row0 + i;
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      rows[i] = min(max(reflect_index(j0 + i, h_glob) - row0, 0), h - 1);
    }
  }
  if (b0 >= 0 && b0 + 4 <= w) {
#pragma unroll
    for (int b = 0; b < 4; ++b) cols[b] = (b0 + b) * c;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) cols[b] = reflect_index(b0 + b, w) * c;
  }
  const int64_t x_row = static_cast<int64_t>(w) * c, y_row = static_cast<int64_t>(wo) * c;
  const T* xn = x + static_cast<int64_t>(blockIdx.z) * h * x_row;
  T* yb = y + (static_cast<int64_t>(blockIdx.z) * ho + o0) * y_row + static_cast<int64_t>(q) * c;
  for (int ch = threadIdx.x * V; ch < c; ch += blockDim.x * V) {
    float acc[R][V];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const T* xr = xn + rows[i] * x_row + ch;
      float r[V];  // this input row summed over the window's columns
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float v[V];
        load_vec<T, V>(xr + cols[b], v);
        fma_into(r, k[b], v, b == 0);
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int a = i - S * rr;  // the tap with which output row o0 + rr reads this row
        if (a < 0 || a > 3) continue;
        fma_into(acc[rr], k[a], r, a == 0);
        if (a == 3 && o0 + rr < ho) store_vec<T, V>(yb + rr * y_row + ch, acc[rr]);
      }
    }
  }
}

template <typename T, int S, int V>
cudaError_t launch_fwd_as(const void* x, void* y, int64_t n, int h, int w, int c, int ho,
                          int wo, int h_glob, int row0, int o_base, cudaStream_t stream) {
  const int vectors = c / V;
  const int tx = vectors < kThreads ? vectors : kThreads;
  const int ty = kThreads / tx;
  const int64_t chunks = (wo + ty - 1) / ty;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const int64_t x_image = static_cast<int64_t>(h) * w * c;
  const int64_t y_image = static_cast<int64_t>(ho) * wo * c;
  const unsigned strips = static_cast<unsigned>((ho + kFwdRows - 1) / kFwdRows);
  for (int64_t n0 = 0; n0 < n; n0 += kMaxImages) {
    const dim3 grid(strips, static_cast<unsigned>(chunks),
                    static_cast<unsigned>(n - n0 < kMaxImages ? n - n0 : kMaxImages));
    blurpool_fwd_kernel<T, S, V><<<grid, dim3(tx, ty), 0, stream>>>(
        static_cast<const T*>(x) + n0 * x_image, static_cast<T*>(y) + n0 * y_image, h, w, c, ho,
        wo, h_glob, row0, o_base);
  }
  return cudaSuccess;
}

// The access width, per launch: 16 bytes a thread and access when C is a
// multiple of it and both pointers are aligned to it, else one scalar. (8
// bytes at stride 1 for pixels of at most 256 bytes, the backward's choice,
// was slower here; every shape of the path takes 16 bytes.)
template <typename T, int S>
cudaError_t launch_fwd_stride(const void* x, void* y, int64_t n, int h, int w, int c, int ho,
                              int wo, int h_glob, int row0, int o_base, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (c % V == 0 && at % 16 == 0) {
    return launch_fwd_as<T, S, V>(x, y, n, h, w, c, ho, wo, h_glob, row0, o_base, stream);
  }
  return launch_fwd_as<T, S, 1>(x, y, n, h, w, c, ho, wo, h_glob, row0, o_base, stream);
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, int64_t n, int h, int w, int c, int ho, int wo,
                       int stride, int h_glob, int row0, int o_base, cudaStream_t stream) {
  return stride == 1
             ? launch_fwd_stride<T, 1>(x, y, n, h, w, c, ho, wo, h_glob, row0, o_base, stream)
             : launch_fwd_stride<T, 2>(x, y, n, h, w, c, ho, wo, h_glob, row0, o_base, stream);
}

// Interior 2 x 2 block at stride 2: dx rows 2m, 2m + 1 read dy rows m - 1, m
// (taps 3, 1) and m, m + 1 (taps 2, 0); the columns alike. src points at dy
// (m - 1, p - 1), dst at dx (2m, 2p), both at the thread's channels.
template <typename T, int V>
__device__ __forceinline__ void interior_s2(const T* src, T* dst, int64_t dy_row,
                                            int64_t dx_row, int c) {
  float se[3][V], so[3][V];  // each dy row summed for dx column 2p and 2p + 1
#pragma unroll
  for (int a = 0; a < 3; ++a, src += dy_row) {
    float v0[V], v1[V], v2[V];
    load_vec<T, V>(src, v0);
    load_vec<T, V>(src + c, v1);
    load_vec<T, V>(src + 2 * c, v2);
    fma_into(se[a], 0.125f, v0, true);
    fma_into(se[a], 0.375f, v1, false);
    fma_into(so[a], 0.375f, v1, true);
    fma_into(so[a], 0.125f, v2, false);
  }
  float o[V];
  fma_into(o, 0.125f, se[0], true);
  fma_into(o, 0.375f, se[1], false);
  store_vec<T, V>(dst, o);
  fma_into(o, 0.125f, so[0], true);
  fma_into(o, 0.375f, so[1], false);
  store_vec<T, V>(dst + c, o);
  fma_into(o, 0.375f, se[1], true);
  fma_into(o, 0.125f, se[2], false);
  store_vec<T, V>(dst + dx_row, o);
  fma_into(o, 0.375f, so[1], true);
  fma_into(o, 0.125f, so[2], false);
  store_vec<T, V>(dst + dx_row + c, o);
}

// Interior 2 x 2 block at stride 1: dx row r reads dy rows r - 2 .. r + 1 with
// the taps reversed (k is symmetric), so the block reads rows 2m - 2 .. 2m + 2
// and the columns alike. src points at dy (2m - 2, 2p - 2), dst at dx (2m, 2p).
template <typename T, int V>
__device__ __forceinline__ void interior_s1(const T* src, T* dst, int64_t dy_row,
                                            int64_t dx_row, int c) {
  const float k[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  float a00[V], a01[V], a10[V], a11[V];  // dx (2m, 2p), (2m, 2p + 1), (2m + 1, 2p), ...
#pragma unroll
  for (int a = 0; a < 5; ++a, src += dy_row) {
    float se[V], so[V];  // this dy row summed for dx column 2p and 2p + 1
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      float v[V];
      load_vec<T, V>(src + b * c, v);
      if (b < 4) fma_into(se, k[b], v, b == 0);
      if (b > 0) fma_into(so, k[b - 1], v, b == 1);
    }
    if (a < 4) {
      fma_into(a00, k[a], se, a == 0);
      fma_into(a01, k[a], so, a == 0);
    }
    if (a > 0) {
      fma_into(a10, k[a - 1], se, a == 1);
      fma_into(a11, k[a - 1], so, a == 1);
    }
  }
  store_vec<T, V>(dst, a00);
  store_vec<T, V>(dst + c, a01);
  store_vec<T, V>(dst + dx_row, a10);
  store_vec<T, V>(dst + dx_row + c, a11);
}

// One dx pixel from its general windows (rows o_lo + i of dy with weight
// wr[i], columns p_lo + j with wc[j]), V channels: dyn points at dy (n, 0, 0)
// and dst at the dx pixel, both at the thread's channels. Every window position is
// loaded, clamped into dy, whatever its weight, so that no load waits for a
// test of a weight; a position of weight 0 adds nothing (the sums are those
// of the positions with weights, in window order).
template <typename T, int S, int V>
__device__ __forceinline__ void border_pixel(const T* dyn, T* dst, int o_lo,
                                             const float (&wr)[kWindow<S>], int p_lo,
                                             const float (&wc)[kWindow<S>], int ho, int wo,
                                             int c) {
  const int64_t dy_row = static_cast<int64_t>(wo) * c;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < kWindow<S>; ++i) {
    const T* dyr = dyn + min(o_lo + i, ho - 1) * dy_row;
    float sum[V];
#pragma unroll
    for (int e = 0; e < V; ++e) sum[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kWindow<S>; ++j) {
      float v[V];
      load_vec<T, V>(dyr + static_cast<int64_t>(min(p_lo + j, wo - 1)) * c, v);
      if (wc[j] != 0.f) fma_into(sum, wc[j], v, false);
    }
    if (wr[i] != 0.f) fma_into(acc, wr[i], sum, false);
  }
  store_vec<T, V>(dst, acc);
}

// block (tx channel vectors, ty column pairs); grid (row pairs, chunks of
// column pairs, images). A thread: V channels of dx rows 2m, 2m + 1 and
// columns 2p, 2p + 1 (those inside the image), for channel vectors threadIdx.x,
// threadIdx.x + tx, ... . dx holds rows [row0, row0 + h) of an h_glob-row map
// and dy its output rows [o_base, o_base + ho); the row pairs are the map's
// (global row 2m, 2m + 1), those that meet the window.
template <typename T, int S, int V>
__global__ void __launch_bounds__(kThreads, 4)
blurpool_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int h, int w, int c,
                    int ho, int wo, int h_glob, int row0, int o_base) {
  const int m = (row0 >> 1) + blockIdx.x;
  const int p = blockIdx.y * blockDim.y + threadIdx.y;
  const int r0 = 2 * m, c0 = 2 * p;
  if (c0 >= w) return;
  const int64_t dy_row = static_cast<int64_t>(wo) * c, dx_row = static_cast<int64_t>(w) * c;
  const T* dyn = dy + static_cast<int64_t>(blockIdx.z) * ho * dy_row;
  T* dxb = dx + (static_cast<int64_t>(blockIdx.z) * h + (r0 - row0)) * dx_row +
           static_cast<int64_t>(c0) * c;
  // no reflected read lands on rows 2 .. h_glob - 4 or columns 2 .. w - 4; the
  // block's rows lie in the window and every output that reads them in dy
  const bool inside = r0 >= row0 && r0 + 1 < row0 + h &&
                      (S == 2 ? m - 1 >= o_base && m + 1 < o_base + ho
                              : r0 - 2 >= o_base && r0 + 2 < o_base + ho);
  if (inside && r0 >= 2 && r0 + 1 <= h_glob - 4 && c0 >= 2 && c0 + 1 <= w - 4) {
    for (int ch = threadIdx.x * V; ch < c; ch += blockDim.x * V) {
      if constexpr (S == 2) {
        interior_s2<T, V>(dyn + (m - 1 - o_base) * dy_row + static_cast<int64_t>(p - 1) * c + ch,
                          dxb + ch, dy_row, dx_row, c);
      } else {
        interior_s1<T, V>(dyn + (r0 - 2 - o_base) * dy_row +
                              static_cast<int64_t>(c0 - 2) * c + ch,
                          dxb + ch, dy_row, dx_row, c);
      }
    }
    return;
  }
  for (int i = 0; i < 2; ++i) {
    if (r0 + i < row0 || r0 + i >= row0 + h) continue;
    float wr[kWindow<S>];
    const int o_lo = adjoint_weights<S>(r0 + i, h_glob, o_base, o_base + ho - 1, wr);
    for (int j = 0; j < 2 && c0 + j < w; ++j) {
      float wc[kWindow<S>];
      const int p_lo = adjoint_weights<S>(c0 + j, w, 0, wo - 1, wc);
      for (int ch = threadIdx.x * V; ch < c; ch += blockDim.x * V) {
        border_pixel<T, S, V>(dyn + ch, dxb + i * dx_row + j * c + ch, o_lo - o_base, wr, p_lo,
                              wc, ho, wo, c);
      }
    }
  }
}

template <typename T, int S, int V>
cudaError_t launch_bwd_as(const void* dy, void* dx, int64_t n, int h, int w, int c, int ho,
                          int wo, int h_glob, int row0, int o_base, cudaStream_t stream) {
  const int vectors = c / V;
  const int tx = vectors < kThreads ? vectors : kThreads;
  const int ty = kThreads / tx;
  const int64_t pairs = (w + 1) / 2;
  const int64_t chunks = (pairs + ty - 1) / ty;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  const int64_t dy_image = static_cast<int64_t>(ho) * wo * c;
  const int64_t dx_image = static_cast<int64_t>(h) * w * c;
  for (int64_t n0 = 0; n0 < n; n0 += kMaxImages) {
    // the global row pairs that meet rows [row0, row0 + h): (h + 1) / 2 for row0 = 0
    const unsigned pairs_h = static_cast<unsigned>(((row0 + h - 1) >> 1) - (row0 >> 1) + 1);
    const dim3 grid(pairs_h, static_cast<unsigned>(chunks),
                    static_cast<unsigned>(n - n0 < kMaxImages ? n - n0 : kMaxImages));
    blurpool_bwd_kernel<T, S, V><<<grid, dim3(tx, ty), 0, stream>>>(
        static_cast<const T*>(dy) + n0 * dy_image, static_cast<T*>(dx) + n0 * dx_image, h, w, c,
        ho, wo, h_glob, row0, o_base);
  }
  return cudaSuccess;
}

// The access width, per launch: 16 bytes a thread and access, but 8 at stride
// 1 where a pixel's channels span at most 256 bytes (C = 64 and 128 in
// bfloat16, where it was faster in turns on the card; at stride 2 and at
// wider pixels it was not), each when C is a multiple of it and both pointers
// are aligned to it; else one scalar.
template <typename T, int S>
cudaError_t launch_bwd_stride(const void* dy, void* dx, int64_t n, int h, int w, int c, int ho,
                              int wo, int h_glob, int row0, int o_base, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx);
  const auto fits = [&](int bytes) { return c % (bytes / sizeof(T)) == 0 && at % bytes == 0; };
  if ((S == 2 || c * sizeof(T) > 256) && fits(16)) {
    return launch_bwd_as<T, S, 16 / sizeof(T)>(dy, dx, n, h, w, c, ho, wo, h_glob, row0, o_base,
                                               stream);
  }
  if (fits(8)) {
    return launch_bwd_as<T, S, 8 / sizeof(T)>(dy, dx, n, h, w, c, ho, wo, h_glob, row0, o_base,
                                              stream);
  }
  return launch_bwd_as<T, S, 1>(dy, dx, n, h, w, c, ho, wo, h_glob, row0, o_base, stream);
}

template <typename T>
cudaError_t launch_bwd(const void* dy, void* dx, int64_t n, int h, int w, int c, int ho, int wo,
                       int stride, int h_glob, int row0, int o_base, cudaStream_t stream) {
  return stride == 1
             ? launch_bwd_stride<T, 1>(dy, dx, n, h, w, c, ho, wo, h_glob, row0, o_base, stream)
             : launch_bwd_stride<T, 2>(dy, dx, n, h, w, c, ho, wo, h_glob, row0, o_base, stream);
}

}  // namespace

// x is rows [row0, row0 + h) of a map of h_glob rows, (n, h, w, c), and y
// its output rows [o_base, o_base + ho), (n, ho, wo, c), both contiguous on
// the current device (the whole map: h_glob = h, row0 = o_base = 0); wo is
// the output width of w at this stride, and the caller checks that every row
// the outputs read (reflected at the map's edges) lies in the window and that
// w * c < 2^31. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError(),
// or cudaErrorInvalidConfiguration for a grid out of its limits (more than
// 65535 chunks of column groups).
extern "C" int tfcgan_blurpool_fwd(const void* x, void* y, int64_t n, int h, int w, int c,
                                   int ho, int wo, int stride, int dtype, void* stream,
                                   int h_glob, int row0, int o_base) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_fwd<float>(x, y, n, h, w, c, ho, wo, stride, h_glob, row0, o_base, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16>(x, y, n, h, w, c, ho, wo, stride, h_glob, row0, o_base, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The adjoint of tfcgan_blurpool_fwd: dy is the output rows [o_base,
// o_base + ho), (n, ho, wo, c), and dx the window's rows [row0, row0 + h), (n,
// h, w, c), each row of dx collecting what the outputs in dy read from it.
// Returns as the forward.
extern "C" int tfcgan_blurpool_bwd(const void* dy, void* dx, int64_t n, int h, int w, int c,
                                   int ho, int wo, int stride, int dtype, void* stream,
                                   int h_glob, int row0, int o_base) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_bwd<float>(dy, dx, n, h, w, c, ho, wo, stride, h_glob, row0, o_base, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(dy, dx, n, h, w, c, ho, wo, stride, h_glob, row0, o_base,
                                    s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

