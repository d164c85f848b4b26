// Flash self-attention and its backward for Hopper (sm_90a): per (batch, head),
//
//   o   = softmax(q^T k * scale) v        scores and probabilities never in device memory
//   lse = log sum_k exp(q^T k * scale)    float32, saved for the backward
//   dq, dk, dv from lse:  p = exp(s - lse),  ds = p * (dp - di) * scale,
//                         dp = do^T v,  di = sum_d o * do  (computed by the caller)
//
// Every tensor is a (N, H, D, S) view given by four element strides (n, h, d, s):
// the (BH, D, S) layout of the JAX entry point is (1, BH, S, 1)-strided, and the
// diffusion U-Net hands in views of its (N, S, H * D) projections, strides
// (S * H * D, D, 1, H * D), and gets its output in the same memory order, so no
// pack or transpose copy is made on either side. lse and di are (N, H, S)
// float32, contiguous. q, k, v, o, do and the gradients share one type, float32
// or bfloat16; all arithmetic is float32.
//
// Replaces the TPU kernels of tfcgan_tpu/ops/pallas_kernels/flashattn.py:
// _fwd_kernel (one pass over the full key extent with an ordinary softmax, which
// exists because that machine's fast memory holds a (256, S) score slab) and
// _bwd_fused_kernel / _dq_kernel / _dkv_kernel (dk and dv carried across a
// sequential grid). Neither design is kept: blocks run in no order here, and a
// thread's registers are the fast memory.
//
// flashattn_fwd_kernel: a thread owns one query (two at D = 8 and 16), with q
// (pre-multiplied by scale * log2 e), the running maximum, the running sum and
// the D-wide accumulator in registers; a block of 128 threads walks the keys in
// tiles of 64, K and V staged through shared memory as float32 once per block
// and read by every thread at the same address (a broadcast). Online softmax
// over chunks of 16 keys: the 16 scores are held in registers, one rescale of
// the accumulator per chunk, then 2^(score - running maximum) by ex2.approx (see
// exp2_approx; never the fast-math exp, and the wrappers build without
// -use_fast_math).
// The ragged tail of S is masked to -inf. For bfloat16 the unnormalised
// probability 2^(s - m) is rounded to bfloat16 before it multiplies v, while
// the running sum keeps the unrounded value; the TPU kernel and the plain
// version normalise first and round p / l. The two roundings differ by one
// bfloat16 ulp of a term (2^-8 relative) and agree in float32.
//
// flashattn_dq_kernel: a thread per query (or two), loops over key tiles,
// recomputes p from lse and accumulates dq in registers. flashattn_dkv_kernel:
// a thread per key (or two), loops over query tiles (q, do, lse and di staged
// through shared memory) and accumulates dk and dv in registers. One writer per
// element and a fixed order of additions: no atomics, two runs repeat bit for
// bit. dv uses p rounded to the tensors' type, as the TPU kernel's dv product
// does; ds stays float32. Either of dk, dv is skipped when its pointer is null.
//
// What bounds them: operations, not bytes. At (N * H, S, D) = (256, 4096, 8)
// bfloat16 the forward moves 71 MB but takes 4.3e9 exponentials and 1.4e11
// multiply-add operations (2 * 2 * D a pair); the backward recomputes p in each
// of its two kernels and does 2 * 3 * D and 2 * 4 * D operations a pair. This
// first design runs them on the float32 units: about 16 multiply-adds and 10
// other operations a pair in the forward at D = 8, and the rate at which an SM
// starts operations is what it waits for. With one row a thread the broadcast reads from shared
// memory (4 of 16 bytes a pair, 4 + 2 in dk/dv) cost as much again, which is why
// a thread owns two rows where the registers allow. D = 64 keeps up to 4 * 64
// floats a thread and spills.
//
// Left for later work: the tensor cores (mma with D padded to the 16-deep
// tile), a fused backward, D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rows a block owns: queries (fwd, dq) or keys (dkv)
constexpr int kTile = 64;      // rows of the other side staged in shared memory a step
constexpr int kChunk = 16;     // scores a forward thread holds between two rescales
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  int64_t n, h, d, s;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 2^x by the special-function unit's own operation, the one exp2f is built
// around: maximum relative error 2^-22 over the whole range (and the scale is
// folded into the argument, so no product is rounded before it, which is what
// loses accuracy in the fast-math exp); results below 2^-126 flush to 0, 2^-inf is 0.
// exp2f adds only the handling of denormal results, which a probability that
// small does not need.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to T and back: what a product with a T-typed probability sees
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [row0, row0 + kTile) of one head's (D, S) view into dst[kTile][D] as
// float32, rows at or beyond s_len as zeros. Neighbouring threads read
// neighbouring addresses along whichever axis is dense.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* base, int64_t sd, int64_t ss,
                                           int row0, int s_len) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    int r, d;
    if (sd == 1) {
      r = i / D;
      d = i % D;
    } else {
      d = i / kTile;
      r = i % kTile;
    }
    const int row = row0 + r;
    dst[r * D + d] = row < s_len ? load_f32(base + row * ss + d * sd) : 0.f;
  }
}

// One staged row into registers: every thread of the block reads the same
// address (a broadcast), 16 bytes at a time.
template <int D>
__device__ __forceinline__ void load_row(float (&dst)[D], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 b = r4[i];
    dst[4 * i] = b.x;
    dst[4 * i + 1] = b.y;
    dst[4 * i + 2] = b.z;
    dst[4 * i + 3] = b.w;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float (&b)[D]) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

// acc += w * row
template <int D>
__device__ __forceinline__ void axpy(float (&acc)[D], float w, const float (&row)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = fmaf(w, row[i], acc[i]);
}

// A thread owns R rows (queries, or keys in dk/dv), kThreads apart, so that a
// staged row read from shared memory feeds R rows' arithmetic: the broadcast
// reads, not the arithmetic, bound the one-row form. Row r of thread t in tile
// `tile` is (tile * R + r) * kThreads + t.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
flashattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int heads, int s_len, int tiles,
                     float scale_log2) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x % tiles) * R * kThreads + threadIdx.x;
  const T* qb = q + n * sq.n + h * sq.h;
  const T* kb = k + n * sk.n + h * sk.h;
  const T* vb = v + n * sv.n + h * sv.h;
  float qr[R][D], acc[R][D], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // a row past the end keeps the block's loads and barriers company on row 0
    const int qi = q0 + r * kThreads;
    const T* qp = qb + (qi < s_len ? qi : 0) * sq.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[r][d] = load_f32(qp + d * sq.d) * scale_log2;
      acc[r][d] = 0.f;
    }
    m[r] = -INFINITY;  // in the base-2 domain: scores are s * log2 e
    l[r] = 0.f;
  }
  for (int t0 = 0; t0 < s_len; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<T, D>(ks, kb, sk.d, sk.s, t0, s_len);
    stage_tile<T, D>(vs, vb, sv.d, sv.s, t0, s_len);
    __syncthreads();
    const int valid = min(kTile, s_len - t0);
#pragma unroll 1
    for (int c0 = 0; c0 < valid; c0 += kChunk) {
      float sc[R][kChunk], cmax[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cmax[r] = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float kk[D];
        load_row<D>(kk, ks + (c0 + j) * D);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sc[r][j] = c0 + j < valid ? dot<D>(qr[r], kk) : -INFINITY;
          cmax[r] = fmaxf(cmax[r], sc[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // key c0 is a real one, so m_new is finite and m - m_new is -inf at most
        const float m_new = fmaxf(m[r], cmax[r]);
        const float corr = exp2_approx(m[r] - m_new);
        l[r] *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[r][d] *= corr;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float vv[D];
        load_row<D>(vv, vs + (c0 + j) * D);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = exp2_approx(sc[r][j] - m[r]);
          l[r] += p;
          axpy<D>(acc[r], round_to<T>(p), vv);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kThreads;
    if (qi < s_len) {
      const float inv = 1.f / l[r];
      T* op = o + n * so.n + h * so.h + qi * so.s;
#pragma unroll
      for (int d = 0; d < D; ++d) store_f32(op + d * so.d, acc[r][d] * inv);
      lse[static_cast<int64_t>(bh) * s_len + qi] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
flashattn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, int heads, int s_len, int tiles,
                    float scale, float scale_log2) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x % tiles) * R * kThreads + threadIdx.x;
  const T* kb = k + n * sk.n + h * sk.h;
  const T* vb = v + n * sv.n + h * sv.h;
  float qr[R][D], dor[R][D], acc[R][D], lse2[R], delta[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kThreads;
    const int row = qi < s_len ? qi : 0;
    const T* qp = q + n * sq.n + h * sq.h + row * sq.s;
    const T* dop = dout + n * sdo.n + h * sdo.h + row * sdo.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[r][d] = load_f32(qp + d * sq.d) * scale_log2;
      dor[r][d] = load_f32(dop + d * sdo.d);
      acc[r][d] = 0.f;
    }
    const int64_t stat = static_cast<int64_t>(bh) * s_len + row;
    lse2[r] = lse[stat] * kLog2e;
    delta[r] = di[stat];
  }
  for (int t0 = 0; t0 < s_len; t0 += kTile) {
    __syncthreads();
    stage_tile<T, D>(ks, kb, sk.d, sk.s, t0, s_len);
    stage_tile<T, D>(vs, vb, sv.d, sv.s, t0, s_len);
    __syncthreads();
    const int valid = min(kTile, s_len - t0);
#pragma unroll 4
    for (int j = 0; j < valid; ++j) {
      float kk[D], vv[D];
      load_row<D>(kk, ks + j * D);
      load_row<D>(vv, vs + j * D);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = exp2_approx(dot<D>(qr[r], kk) - lse2[r]);
        axpy<D>(acc[r], p * (dot<D>(dor[r], vv) - delta[r]), kk);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kThreads;
    if (qi < s_len) {
      T* dqp = dq + n * sdq.n + h * sdq.h + qi * sdq.s;
#pragma unroll
      for (int d = 0; d < D; ++d) store_f32(dqp + d * sdq.d, acc[r][d] * scale);
    }
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
flashattn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int heads, int s_len, int tiles, float scale, float scale_log2) {
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ __align__(8) float2 stats[kTile];  // (lse * log2 e, di) of the staged queries
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int k0 = (blockIdx.x % tiles) * R * kThreads + threadIdx.x;
  const T* qb = q + n * sq.n + h * sq.h;
  const T* dob = dout + n * sdo.n + h * sdo.h;
  const float* lse_b = lse + static_cast<int64_t>(bh) * s_len;
  const float* di_b = di + static_cast<int64_t>(bh) * s_len;
  const bool want_dk = dk != nullptr, want_dv = dv != nullptr;
  float kr[R][D], vr[R][D], acc_k[R][D], acc_v[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + r * kThreads;
    const int row = kj < s_len ? kj : 0;
    const T* kp = k + n * sk.n + h * sk.h + row * sk.s;
    const T* vp = v + n * sv.n + h * sv.h + row * sv.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[r][d] = load_f32(kp + d * sk.d) * scale_log2;
      vr[r][d] = load_f32(vp + d * sv.d);
      acc_k[r][d] = 0.f;
      acc_v[r][d] = 0.f;
    }
  }
  for (int t0 = 0; t0 < s_len; t0 += kTile) {
    __syncthreads();
    stage_tile<T, D>(qs, qb, sq.d, sq.s, t0, s_len);
    stage_tile<T, D>(dos, dob, sdo.d, sdo.s, t0, s_len);
    if (threadIdx.x < kTile) {
      const int i = t0 + threadIdx.x;
      stats[threadIdx.x] = i < s_len ? make_float2(lse_b[i] * kLog2e, di_b[i])
                                     : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int valid = min(kTile, s_len - t0);
#pragma unroll 4
    for (int i = 0; i < valid; ++i) {
      float qq[D], dd[D];
      load_row<D>(qq, qs + i * D);
      load_row<D>(dd, dos + i * D);
      const float2 st = stats[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = exp2_approx(dot<D>(kr[r], qq) - st.x);
        if (want_dv) axpy<D>(acc_v[r], round_to<T>(p), dd);
        if (want_dk) axpy<D>(acc_k[r], p * (dot<D>(vr[r], dd) - st.y), qq);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + r * kThreads;
    if (kj < s_len) {
      if (want_dk) {
        T* dkp = dk + n * sdk.n + h * sdk.h + kj * sdk.s;
#pragma unroll
        for (int d = 0; d < D; ++d) store_f32(dkp + d * sdk.d, acc_k[r][d] * scale);
      }
      if (want_dv) {
        T* dvp = dv + n * sdv.n + h * sdv.h + kj * sdv.s;
#pragma unroll
        for (int d = 0; d < D; ++d) store_f32(dvp + d * sdv.d, acc_v[r][d]);
      }
    }
  }
}

// rows a thread owns: 2 while the accumulators of two rows fit in registers
template <int D>
constexpr int rows_per_thread() {
  return D <= 16 ? 2 : 1;
}

int tiles_for(int s_len, int rows) { return (s_len + kThreads * rows - 1) / (kThreads * rows); }

Strides strides_at(const int64_t* p, int i) {
  return Strides{p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]};
}

template <typename T, int D>
void launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                const int64_t* st, int n, int heads, int s_len, float scale, cudaStream_t s) {
  constexpr int R = rows_per_thread<D>();
  const int tiles = tiles_for(s_len, R);
  const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
  flashattn_fwd_kernel<T, D, R><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), heads, s_len, tiles, scale * kLog2e);
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dq, const int64_t* st, int n, int heads, int s_len,
               float scale, cudaStream_t s) {
  constexpr int R = rows_per_thread<D>();
  const int tiles = tiles_for(s_len, R);
  const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
  flashattn_dq_kernel<T, D, R><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), heads, s_len,
      tiles, scale, scale * kLog2e);
}

template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* di, void* dk, void* dv, const int64_t* st, int n, int heads,
                int s_len, float scale, cudaStream_t s) {
  constexpr int R = rows_per_thread<D>();
  const int tiles = tiles_for(s_len, R);
  const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
  flashattn_dkv_kernel<T, D, R><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv),
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), heads, s_len, tiles, scale, scale * kLog2e);
}

// CALL(launch_x, args...) for the (dtype, d) at hand; false when there is none
#define TFCGAN_FLASHATTN_DISPATCH(FN, ...)                                  \
  [&]() -> bool {                                                           \
    if (dtype == 0) {                                                       \
      if (d == 8) return FN<float, 8>(__VA_ARGS__), true;                   \
      if (d == 16) return FN<float, 16>(__VA_ARGS__), true;                 \
      if (d == 32) return FN<float, 32>(__VA_ARGS__), true;                 \
      if (d == 64) return FN<float, 64>(__VA_ARGS__), true;                 \
    } else if (dtype == 1) {                                                \
      if (d == 8) return FN<__nv_bfloat16, 8>(__VA_ARGS__), true;           \
      if (d == 16) return FN<__nv_bfloat16, 16>(__VA_ARGS__), true;         \
      if (d == 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__), true;         \
      if (d == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__), true;         \
    }                                                                       \
    return false;                                                           \
  }()

}  // namespace

// All three take (N, H, D, S) views on the current device, each given by four
// element strides (n, h, d, s) in `strides` (a host array, one group of four per
// tensor in the order of the pointer arguments that are views), and return
// cudaGetLastError(). The caller checks: n, heads, s_len >= 1, d in {8, 16, 32,
// 64}, n * heads * ceil(s_len / 128) below 2^31, no output overlapping itself.
// dtype: 0 = float32, 1 = bfloat16 (of every view); lse and di are (N, H, S)
// float32, contiguous.

extern "C" int tfcgan_flashattn_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, const int64_t* strides, int n, int heads,
                                    int s_len, int d, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!TFCGAN_FLASHATTN_DISPATCH(launch_fwd, q, k, v, o, lse, strides, n, heads, s_len, scale, s))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, dout, dq
extern "C" int tfcgan_flashattn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* di,
                                       void* dq, const int64_t* strides, int n, int heads,
                                       int s_len, int d, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!TFCGAN_FLASHATTN_DISPATCH(launch_dq, q, k, v, dout, lse, di, dq, strides, n, heads, s_len,
                                 scale, s))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, dout, dk, dv (a skipped gradient's four are not read). dk or
// dv may be null, not both.
extern "C" int tfcgan_flashattn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* di,
                                        void* dk, void* dv, const int64_t* strides, int n,
                                        int heads, int s_len, int d, float scale, int dtype,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk == nullptr && dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!TFCGAN_FLASHATTN_DISPATCH(launch_dkv, q, k, v, dout, lse, di, dk, dv, strides, n, heads,
                                 s_len, scale, s))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
