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
// or bfloat16; every sum is float32 (the tensor cores multiply bfloat16 operands
// exactly and accumulate in float32).
//
// Queries and keys have lengths of their own: q, o, do, dq, lse and di hold
// q_len rows, k, v, dk and dv k_len. On the spatial mesh axis a rank computes
// the queries of its rows of the map against the keys of the whole map,
// gathered once (q_len < k_len; the attention has no mask, so no position
// offset is needed); q_len == k_len is one sequence's self-attention, the same
// launch as before the two lengths were split. Each kernel masks the tail of
// the side it walks at that side's length: the forward and dq walk keys, dk/dv
// walks queries, and each block owns rows of the other side.
//
// Replaces the TPU kernels of tfcgan_tpu/ops/pallas_kernels/flashattn.py:
// _fwd_kernel (one pass over the full key extent with an ordinary softmax, which
// exists because that machine's fast memory holds a (256, S) score slab) and
// _bwd_fused_kernel / _dq_kernel / _dkv_kernel (dk and dv carried across a
// sequential grid). Neither design is kept: blocks run in no order here, and a
// thread's registers are the fast memory.
//
// Every entry takes one of two designs, chosen by the tensors' type in the C
// entries (an explicit dispatch: a type has one kernel, never a fallback):
// float32 on the float32 units, bfloat16 on the tensor cores. The tensor cores
// would need TF32 for float32, whose 10-bit mantissa misses the float32 window
// (2e-5 of max for the forward, 1e-4 for the gradients).
//
// float32, flashattn_fwd_kernel: a thread owns one query (two at D = 8 and 16),
// with q (pre-multiplied by scale * log2 e), the running maximum, the running
// sum and the D-wide accumulator in registers; a block of 128 threads walks the
// keys in tiles of 64, K and V staged through shared memory as float32 once per
// block and read by every thread at the same address (a broadcast). Online
// softmax over chunks of 16 keys: the 16 scores are held in registers, one
// rescale of the accumulator per chunk, then 2^(score - running maximum) by
// ex2.approx (see exp2_approx; never the fast-math exp, and the wrappers build
// without -use_fast_math). The ragged tail of S is masked to -inf.
//
// bfloat16, flashattn_fwd_tc_kernel: the block and tile shape of the
// tensor-core backward below. A block of 4 warps owns 64 queries, 16 a warp,
// whose q fragments (bfloat16, unscaled: pre-scaling in bfloat16 would add a
// rounding) it loads once; it walks K/V tiles of 64 keys, double-buffered in
// shared memory. S = Q K^T on the tensor cores into float32 accumulators; the
// online softmax works in those registers: the row maximum over the tile is
// taken across the quad of threads that holds the row (two shuffles), O and the
// running sum l are rescaled once a tile, and p = 2^(fma(s, scale * log2 e,
// -m)) (one rounding, then the exponential). l sums the unrounded p, each
// thread over its own columns, the quad's shares added once at the end. P is
// rounded to bfloat16 and packed from the C fragments straight into the A
// operand of O += P V (V through ldmatrix.trans). Keys at or past S are
// masked in the last tile only. O is written once through the output's
// strides, times 1 / l; lse = (m + log2 l) ln 2 once per query.
//
// Both forwards round the unnormalised probability 2^(s - m) to the input's
// type before it multiplies v (a no-op in float32), while the running sum
// keeps the unrounded value; the TPU kernel and the plain version normalise
// first and round p / l. The two roundings differ by one bfloat16 ulp of a
// term (2^-8 relative) and agree in float32.
//
// float32, flashattn_dq_kernel and flashattn_dkv_kernel: a thread per query (dq)
// or per key (dk/dv), one or two rows a thread, loops over tiles of the other
// side staged through shared memory as float32, recomputes p from lse and
// accumulates in registers on the float32 units.
//
// bfloat16, flashattn_dq_tc_kernel and flashattn_dkv_tc_kernel: the products on
// the tensor cores, mma.sync m16n8k8 (D = 8) and m16n8k16 with bfloat16 operands
// and float32 accumulation. A block of 4 warps owns 64 rows (queries in dq, keys
// in dk/dv), 16 a warp (the mma's m), whose q and do (k and v) fragments it
// loads once into registers; it walks tiles of 64 rows of the other side,
// double-buffered in shared memory ([row][D] bfloat16, rows padded to an odd
// number of 16-byte units so that ldmatrix is free of bank conflicts) and staged
// by 16-byte cp.async copies where a row of D values is one dense, aligned run
// (the path's (N, S, H * D) projections), element by element otherwise.
//   dq:    S = Q K^T and dP = dO V^T (contraction over D), P = 2^(S * scale *
//          log2 e - lse * log2 e) in the accumulator registers (one fused
//          multiply-add, so the exponent is an exact difference), dS = P (dP -
//          di) with di folded into dP's initial accumulator, rounded to bfloat16
//          and taken straight from the accumulator fragments as the A operand of
//          dQ += dS K: the C layout of two n8 tiles is the A layout of one k16.
//   dk/dv: the transpose: S^T = K Q^T and dP^T = V dO^T, lse and di varying
//          along the accumulator's columns (queries), read as float4 pairs
//          from a staged (-lse * log2 e, -di) table whose rows past the end are
//          (-inf, 0): masked queries give p = 0 with no test. P^T rounded to
//          bfloat16 for dV += P^T dO (as the TPU kernel rounds p for dv), dS^T
//          rounded for dK += dS^T Q.
// K, V (Q, dO) enter the products over keys (queries) through ldmatrix.trans.
// dQ, dK, dV stay in float32 registers and are written once, times scale where
// it belongs. Masked keys in dq (the ragged tail of S) are set to p = 0 in the
// last tile only; rows at or beyond S are neither read past the end of lse/di
// nor written.
//
// Every kernel: one writer per element and a fixed order of additions, no
// atomics, two runs repeat bit for bit. Either of dk, dv is skipped (with its
// products) when its pointer is null.
//
// What bounds them: operations, not bytes. At (N * H, S, D) = (256, 4096, 8)
// bfloat16 the forward moves 71 MB but takes 4.3e9 exponentials and 1.4e11
// multiply-add operations (2 * 2 * D a pair); the backward recomputes p in each
// of its two kernels and does 2 * 3 * D and 2 * 4 * D operations a pair. The
// float32 kernels run them on the float32 units: about 16 multiply-adds and 10
// other operations a pair in the forward at D = 8, and the rate at which an SM
// starts operations is what it waits for. With one row a thread the broadcast
// reads from shared memory (4 of 16 bytes a pair, 4 + 2 in dk/dv) cost as much
// again, which is why a thread owns two rows where the registers allow. D = 64
// keeps up to 4 * 64 floats a thread and spills. On the tensor cores the
// products cost a few instructions a warp per 256 pairs, and what is left a
// pair is one exponential (16 a clock an SM: the bound) and two to four float32
// operations (the forward: the maximum, the fused exponent, the sum, half a
// pack to bfloat16).
//
// Left for later work: a fused backward (it would reduce dq across key blocks:
// float32 atomics, which break the bit-identical repeats, or a partial-dq
// workspace of 2 GB at S = 4096), D = 128 (one more instantiation of the
// tensor-core kernels, whose accumulators D is a template parameter of; the
// float32 dk/dv kernel would spill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // rows a block owns: queries (fwd, dq) or keys (dkv)
constexpr int kTile = 64;      // rows of the other side staged in shared memory a step
constexpr int kChunk = 16;     // scores a forward thread holds between two rescales
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  int64_t n, h, d, s;
};

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

// Rows [row0, row0 + kTile) of one head's (D, S) view into dst[kTile][D] as
// float32, rows at or beyond s_len as zeros. Neighbouring threads read
// neighbouring addresses along whichever axis is dense.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* base, int64_t sd, int64_t ss,
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
    dst[r * D + d] = row < s_len ? base[row * ss + d * sd] : 0.f;
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
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
flashattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                     int heads, int q_len, int k_len, int tiles, float scale_log2) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x % tiles) * R * kThreads + threadIdx.x;
  const float* qb = q + n * sq.n + h * sq.h;
  const float* kb = k + n * sk.n + h * sk.h;
  const float* vb = v + n * sv.n + h * sv.h;
  float qr[R][D], acc[R][D], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // a row past the end keeps the block's loads and barriers company on row 0
    const int qi = q0 + r * kThreads;
    const float* qp = qb + (qi < q_len ? qi : 0) * sq.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[r][d] = qp[d * sq.d] * scale_log2;
      acc[r][d] = 0.f;
    }
    m[r] = -INFINITY;  // in the base-2 domain: scores are s * log2 e
    l[r] = 0.f;
  }
  for (int t0 = 0; t0 < k_len; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage_tile<D>(ks, kb, sk.d, sk.s, t0, k_len);
    stage_tile<D>(vs, vb, sv.d, sv.s, t0, k_len);
    __syncthreads();
    const int valid = min(kTile, k_len - t0);
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
          axpy<D>(acc[r], p, vv);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kThreads;
    if (qi < q_len) {
      const float inv = 1.f / l[r];
      float* op = o + n * so.n + h * so.h + qi * so.s;
#pragma unroll
      for (int d = 0; d < D; ++d) op[d * so.d] = acc[r][d] * inv;
      lse[static_cast<int64_t>(bh) * q_len + qi] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
flashattn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                    Strides sdq, int heads, int q_len, int k_len, int tiles, float scale,
                    float scale_log2) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int q0 = (blockIdx.x % tiles) * R * kThreads + threadIdx.x;
  const float* kb = k + n * sk.n + h * sk.h;
  const float* vb = v + n * sv.n + h * sv.h;
  float qr[R][D], dor[R][D], acc[R][D], lse2[R], delta[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kThreads;
    const int row = qi < q_len ? qi : 0;
    const float* qp = q + n * sq.n + h * sq.h + row * sq.s;
    const float* dop = dout + n * sdo.n + h * sdo.h + row * sdo.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[r][d] = qp[d * sq.d] * scale_log2;
      dor[r][d] = dop[d * sdo.d];
      acc[r][d] = 0.f;
    }
    const int64_t stat = static_cast<int64_t>(bh) * q_len + row;
    lse2[r] = lse[stat] * kLog2e;
    delta[r] = di[stat];
  }
  for (int t0 = 0; t0 < k_len; t0 += kTile) {
    __syncthreads();
    stage_tile<D>(ks, kb, sk.d, sk.s, t0, k_len);
    stage_tile<D>(vs, vb, sv.d, sv.s, t0, k_len);
    __syncthreads();
    const int valid = min(kTile, k_len - t0);
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
    if (qi < q_len) {
      float* dqp = dq + n * sdq.n + h * sdq.h + qi * sdq.s;
#pragma unroll
      for (int d = 0; d < D; ++d) dqp[d * sdq.d] = acc[r][d] * scale;
    }
  }
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads)
flashattn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     float* __restrict__ dk, float* __restrict__ dv,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int heads, int q_len, int k_len, int tiles, float scale, float scale_log2) {
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ __align__(8) float2 stats[kTile];  // (lse * log2 e, di) of the staged queries
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int k0 = (blockIdx.x % tiles) * R * kThreads + threadIdx.x;
  const float* qb = q + n * sq.n + h * sq.h;
  const float* dob = dout + n * sdo.n + h * sdo.h;
  const float* lse_b = lse + static_cast<int64_t>(bh) * q_len;
  const float* di_b = di + static_cast<int64_t>(bh) * q_len;
  const bool want_dk = dk != nullptr, want_dv = dv != nullptr;
  float kr[R][D], vr[R][D], acc_k[R][D], acc_v[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + r * kThreads;
    const int row = kj < k_len ? kj : 0;
    const float* kp = k + n * sk.n + h * sk.h + row * sk.s;
    const float* vp = v + n * sv.n + h * sv.h + row * sv.s;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[r][d] = kp[d * sk.d] * scale_log2;
      vr[r][d] = vp[d * sv.d];
      acc_k[r][d] = 0.f;
      acc_v[r][d] = 0.f;
    }
  }
  for (int t0 = 0; t0 < q_len; t0 += kTile) {
    __syncthreads();
    stage_tile<D>(qs, qb, sq.d, sq.s, t0, q_len);
    stage_tile<D>(dos, dob, sdo.d, sdo.s, t0, q_len);
    if (threadIdx.x < kTile) {
      const int i = t0 + threadIdx.x;
      stats[threadIdx.x] = i < q_len ? make_float2(lse_b[i] * kLog2e, di_b[i])
                                     : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const int valid = min(kTile, q_len - t0);
#pragma unroll 4
    for (int i = 0; i < valid; ++i) {
      float qq[D], dd[D];
      load_row<D>(qq, qs + i * D);
      load_row<D>(dd, dos + i * D);
      const float2 st = stats[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = exp2_approx(dot<D>(kr[r], qq) - st.x);
        if (want_dv) axpy<D>(acc_v[r], p, dd);
        if (want_dk) axpy<D>(acc_k[r], p * (dot<D>(vr[r], dd) - st.y), qq);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + r * kThreads;
    if (kj < k_len) {
      if (want_dk) {
        float* dkp = dk + n * sdk.n + h * sdk.h + kj * sdk.s;
#pragma unroll
        for (int d = 0; d < D; ++d) dkp[d * sdk.d] = acc_k[r][d] * scale;
      }
      if (want_dv) {
        float* dvp = dv + n * sdv.n + h * sdv.h + kj * sdv.s;
#pragma unroll
        for (int d = 0; d < D; ++d) dvp[d * sdv.d] = acc_v[r][d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 backward on the tensor cores (see the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcRows = 64;      // rows a block owns, 16 a warp
constexpr int kTcTile = 64;      // rows of the other side staged a step

// Row pitch of a staged [row][D] tile in bfloat16 elements: an odd number of
// 16-byte units, so that the 8 rows an ldmatrix phase reads fall in 8 distinct
// bank groups.
template <int D>
__host__ __device__ constexpr int tc_pitch() {
  return D == 8 ? 8 : D + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b, a 16 x 8 (two registers), b 8 x 8 (one)
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
// c += a b, a 16 x 16 (four registers), b 16 x 8 (two)
__device__ __forceinline__ void mma_k16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bfloat16, lo in the low half: two adjacent columns of a
// fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of this thread's rows (r0 and r0 + 8 of one head's (D, S)
// view; zeros at or beyond s_len) for a product over D: register 2j + i holds
// row r0 + 8i, columns 8j + 2t and 8j + 2t + 1. At D = 8 that is m16n8k8's A,
// above it four registers 4c.. are the k16 chunk c of m16n8k16's A.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 4], const bf16* base, int64_t sd,
                                       int64_t ss, int r0, int s_len, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      uint32_t lo = 0, hi = 0;
      if (row < s_len) {
        const bf16* p = base + row * ss + (8 * j + 2 * t) * sd;
        lo = __bfloat16_as_ushort(p[0]);
        hi = __bfloat16_as_ushort(p[sd]);
      }
      a[2 * j + i] = lo | (hi << 16);
    }
  }
}

// Rows [row0, row0 + kTcTile) of one head's (D, S) view into dst[kTcTile][pitch],
// zeros at or beyond s_len: 16-byte cp.async copies where `dense` (a row is
// one aligned run of D values), else element by element along the dense axis.
template <int D>
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* base, int64_t sd, int64_t ss,
                                         int row0, int s_len, bool dense) {
  constexpr int P = tc_pitch<D>(), C = D / 8;
  if (dense) {
    for (int i = threadIdx.x; i < kTcTile * C; i += kTcThreads) {
      const int r = i / C, c = i % C, row = row0 + r;
      const bool live = row < s_len;
      cp_async16(smem_addr(dst + r * P + 8 * c), live ? base + row * ss + 8 * c : base, live);
    }
  } else {
    for (int i = threadIdx.x; i < kTcTile * D; i += kTcThreads) {
      int r, d;
      if (sd == 1) {
        r = i / D;
        d = i % D;
      } else {
        d = i / kTcTile;
        r = i % kTcTile;
      }
      const int row = row0 + r;
      dst[r * P + d] = row < s_len ? base[row * ss + d * sd] : __float2bfloat16_rn(0.f);
    }
  }
}

// c += x y^T for the 16 rows of x in registers (A fragment xa) and the 16
// staged rows [r, r + 16) of `tile` as y ([row][D]): c[h] holds staged rows
// r + 8h .. r + 8h + 7 as its 8 columns.
template <int D>
__device__ __forceinline__ void mma_rows(float (&c)[2][4], const uint32_t (&xa)[D / 4],
                                         const bf16* tile, int r, int lane) {
  constexpr int P = tc_pitch<D>();
  if constexpr (D == 8) {
    uint32_t b[2];
    ldsm_x2(b, smem_addr(tile + (r + lane % 16) * P));
    mma_k8(c[0], xa[0], xa[1], b[0]);
    mma_k8(c[1], xa[0], xa[1], b[1]);
  } else {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      ldsm_x4(b, smem_addr(tile + (r + (lane / 16) * 8 + lane % 8) * P + 16 * j +
                           ((lane / 8) % 2) * 8));
      mma_k16(c[0], xa[4 * j], xa[4 * j + 1], xa[4 * j + 2], xa[4 * j + 3], b[0], b[1]);
      mma_k16(c[1], xa[4 * j], xa[4 * j + 1], xa[4 * j + 2], xa[4 * j + 3], b[2], b[3]);
    }
  }
}

// acc += a y for a (16 x 16, A fragment over the staged rows [r, r + 16)) and
// those rows of `tile` as y (16 x D), through transposing loads.
template <int D>
__device__ __forceinline__ void mma_over_rows(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                              const bf16* tile, int r, int lane) {
  constexpr int P = tc_pitch<D>();
  if constexpr (D == 8) {
    uint32_t b[2];
    ldsm_x2_trans(b, smem_addr(tile + (r + lane % 16) * P));
    mma_k16(acc[0], a[0], a[1], a[2], a[3], b[0], b[1]);
  } else {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(b, smem_addr(tile + (r + lane % 8 + ((lane / 8) % 2) * 8) * P + 16 * j +
                                 (lane / 16) * 8));
      mma_k16(acc[2 * j], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_k16(acc[2 * j + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
}

// One staged tile of keys for one warp's 16 queries; kMask: the tile holds
// only `valid` live keys (the last one).
template <int D, bool kMask>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], const uint32_t (&qa)[D / 4],
                                        const uint32_t (&da)[D / 4], const float (&nlse2)[2],
                                        const float (&ndi)[2], const bf16* ks, const bf16* vs,
                                        int valid, float scale_log2) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int c = 0; c < kTcTile / 16; ++c) {
    if (kMask && c * 16 >= valid) break;
    float s[2][4], dp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[h][e] = 0.f;
        dp[h][e] = ndi[e / 2];  // dP - di, from the mma
      }
    }
    mma_rows<D>(s, qa, ks, 16 * c, lane);
    mma_rows<D>(dp, da, vs, 16 * c, lane);
    // element e of tile h: query row g + 8 (e / 2), key 16c + 8h + 2t + e % 2
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[h][e], scale_log2, nlse2[e / 2]));
        if (kMask && 16 * c + 8 * h + 2 * t + e % 2 >= valid) p = 0.f;
        ds[e] = p * dp[h][e];
      }
      a[2 * h] = pack_bf16(ds[0], ds[1]);
      a[2 * h + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_over_rows<D>(acc, a, ks, 16 * c, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flashattn_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdq, int heads, int q_len, int k_len, int tiles, float scale,
                       float scale_log2, bool k_dense, bool v_dense) {
  constexpr int P = tc_pitch<D>();
  __shared__ __align__(16) bf16 ks[2][kTcTile * P];
  __shared__ __align__(16) bf16 vs[2][kTcTile * P];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32, t = lane % 4;
  // this thread's query rows r0 and r0 + 8
  const int r0 = (blockIdx.x % tiles) * kTcRows + (threadIdx.x / 32) * 16 + lane / 4;
  uint32_t qa[D / 4], da[D / 4];
  load_a<D>(qa, q + n * sq.n + h * sq.h, sq.d, sq.s, r0, q_len, t);
  load_a<D>(da, dout + n * sdo.n + h * sdo.h, sdo.d, sdo.s, r0, q_len, t);
  float nlse2[2], ndi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const int64_t stat = static_cast<int64_t>(bh) * q_len + row;
    nlse2[i] = row < q_len ? -lse[stat] * kLog2e : 0.f;
    ndi[i] = row < q_len ? -di[stat] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* kb = k + n * sk.n + h * sk.h;
  const bf16* vb = v + n * sv.n + h * sv.h;
  const int steps = (k_len + kTcTile - 1) / kTcTile;
  stage_tc<D>(ks[0], kb, sk.d, sk.s, 0, k_len, k_dense);
  stage_tc<D>(vs[0], vb, sv.d, sv.s, 0, k_len, v_dense);
  cp_async_commit();
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < steps) {  // the next tile into the other buffer, freed by the last barrier
      stage_tc<D>(ks[buf ^ 1], kb, sk.d, sk.s, (it + 1) * kTcTile, k_len, k_dense);
      stage_tc<D>(vs[buf ^ 1], vb, sv.d, sv.s, (it + 1) * kTcTile, k_len, v_dense);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int valid = min(kTcTile, k_len - it * kTcTile);
    if (valid == kTcTile)
      dq_tile<D, false>(acc, qa, da, nlse2, ndi, ks[buf], vs[buf], valid, scale_log2);
    else
      dq_tile<D, true>(acc, qa, da, nlse2, ndi, ks[buf], vs[buf], valid, scale_log2);
    __syncthreads();
  }
  bf16* dqb = dq + n * sdq.n + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= q_len) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      bf16* p = dqb + row * sdq.s + (8 * j + 2 * t) * sdq.d;
      p[0] = __float2bfloat16_rn(acc[j][2 * i] * scale);
      p[sdq.d] = __float2bfloat16_rn(acc[j][2 * i + 1] * scale);
    }
  }
}

// One staged tile of queries for one warp's 16 keys, for dK (kDk) and dV (kDv).
// stats[i] = (-lse_i * log2 e, -di_i), (-inf, 0) past the end of S; kTail: the
// tile holds only `valid` live queries (the last one), and the rest is skipped.
template <int D, bool kDk, bool kDv, bool kTail>
__device__ __forceinline__ void dkv_tile(float (&acc_k)[D / 8][4], float (&acc_v)[D / 8][4],
                                         const uint32_t (&ka)[D / 4], const uint32_t (&va)[D / 4],
                                         const bf16* qs, const bf16* dos, const float2* stats,
                                         int valid, float scale_log2) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int c = 0; c < kTcTile / 16; ++c) {
    if (kTail && 16 * c >= valid) break;
    // the two queries 16c + 8h + 2t and + 1 of this thread's columns in tile h
    float4 st[2];
    float s[2][4], dp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st[h] = *reinterpret_cast<const float4*>(stats + 16 * c + 8 * h + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[h][e] = 0.f;
        dp[h][e] = e % 2 ? st[h].w : st[h].y;  // dP^T - di, from the mma
      }
    }
    mma_rows<D>(s, ka, qs, 16 * c, lane);
    if (kDk) mma_rows<D>(dp, va, dos, 16 * c, lane);
    // element e of tile h: key row g + 8 (e / 2), query 16c + 8h + 2t + e % 2
    uint32_t pa[4], sa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = exp2_approx(fmaf(s[h][e], scale_log2, e % 2 ? st[h].z : st[h].x));
      pa[2 * h] = pack_bf16(p[0], p[1]);
      pa[2 * h + 1] = pack_bf16(p[2], p[3]);
      sa[2 * h] = pack_bf16(p[0] * dp[h][0], p[1] * dp[h][1]);
      sa[2 * h + 1] = pack_bf16(p[2] * dp[h][2], p[3] * dp[h][3]);
    }
    if (kDv) mma_over_rows<D>(acc_v, pa, dos, 16 * c, lane);
    if (kDk) mma_over_rows<D>(acc_k, sa, qs, 16 * c, lane);
  }
}

template <int D, bool kDk, bool kDv>
__global__ void __launch_bounds__(kTcThreads)
flashattn_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq, Strides sk,
                        Strides sv, Strides sdo, Strides sdk, Strides sdv, int heads, int q_len,
                        int k_len, int tiles, float scale, float scale_log2, bool q_dense,
                        bool do_dense) {
  constexpr int P = tc_pitch<D>();
  __shared__ __align__(16) bf16 qs[2][kTcTile * P];
  __shared__ __align__(16) bf16 dos[2][kTcTile * P];
  __shared__ __align__(16) float2 stats[2][kTcTile];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32, t = lane % 4;
  // this thread's key rows r0 and r0 + 8
  const int r0 = (blockIdx.x % tiles) * kTcRows + (threadIdx.x / 32) * 16 + lane / 4;
  uint32_t ka[D / 4], va[D / 4];
  load_a<D>(ka, k + n * sk.n + h * sk.h, sk.d, sk.s, r0, k_len, t);
  load_a<D>(va, v + n * sv.n + h * sv.h, sv.d, sv.s, r0, k_len, t);
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  }
  const bf16* qb = q + n * sq.n + h * sq.h;
  const bf16* dob = dout + n * sdo.n + h * sdo.h;
  const float* lse_b = lse + static_cast<int64_t>(bh) * q_len;
  const float* di_b = di + static_cast<int64_t>(bh) * q_len;
  auto stat = [&](int i) {
    return i < q_len ? make_float2(-lse_b[i] * kLog2e, -di_b[i]) : make_float2(-INFINITY, 0.f);
  };
  const int steps = (q_len + kTcTile - 1) / kTcTile;
  stage_tc<D>(qs[0], qb, sq.d, sq.s, 0, q_len, q_dense);
  stage_tc<D>(dos[0], dob, sdo.d, sdo.s, 0, q_len, do_dense);
  cp_async_commit();
  if (threadIdx.x < kTcTile) stats[0][threadIdx.x] = stat(threadIdx.x);
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < steps;
    float2 next = make_float2(0.f, 0.f);
    if (more) {  // the next tile into the other buffer, freed by the last barrier
      stage_tc<D>(qs[buf ^ 1], qb, sq.d, sq.s, (it + 1) * kTcTile, q_len, q_dense);
      stage_tc<D>(dos[buf ^ 1], dob, sdo.d, sdo.s, (it + 1) * kTcTile, q_len, do_dense);
      if (threadIdx.x < kTcTile) next = stat((it + 1) * kTcTile + threadIdx.x);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int valid = min(kTcTile, q_len - it * kTcTile);
    if (valid == kTcTile)
      dkv_tile<D, kDk, kDv, false>(acc_k, acc_v, ka, va, qs[buf], dos[buf], stats[buf], valid,
                                   scale_log2);
    else
      dkv_tile<D, kDk, kDv, true>(acc_k, acc_v, ka, va, qs[buf], dos[buf], stats[buf], valid,
                                  scale_log2);
    if (more && threadIdx.x < kTcTile) stats[buf ^ 1][threadIdx.x] = next;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= k_len) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (kDk) {
        bf16* p = dk + n * sdk.n + h * sdk.h + row * sdk.s + (8 * j + 2 * t) * sdk.d;
        p[0] = __float2bfloat16_rn(acc_k[j][2 * i] * scale);
        p[sdk.d] = __float2bfloat16_rn(acc_k[j][2 * i + 1] * scale);
      }
      if (kDv) {
        bf16* p = dv + n * sdv.n + h * sdv.h + row * sdv.s + (8 * j + 2 * t) * sdv.d;
        p[0] = __float2bfloat16_rn(acc_v[j][2 * i]);
        p[sdv.d] = __float2bfloat16_rn(acc_v[j][2 * i + 1]);
      }
    }
  }
}

// One staged tile of keys for one warp's 16 queries: S = Q K^T, the online
// softmax in the accumulator registers (one rescale of O and l a tile), then
// O += P V. m is the running maximum of the scaled scores in the base-2 domain,
// l this thread's share of the running sum (its columns only; the quad's
// shares are added once, at the end). kMask: the tile holds only `valid` live
// keys (the last one).
template <int D, bool kMask>
__device__ __forceinline__ void fwd_tile(float (&acc)[D / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qa)[D / 4], const bf16* ks,
                                         const bf16* vs, int valid, float scale_log2) {
  constexpr int C = kTcTile / 16;
  const int lane = threadIdx.x % 32, t = lane % 4;
  // element e of s[c][h]: query row g + 8 (e / 2), key 16c + 8h + 2t + e % 2
  float s[C][2][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) s[c][h][0] = s[c][h][1] = s[c][h][2] = s[c][h][3] = 0.f;
    mma_rows<D>(s[c], qa, ks, 16 * c, lane);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kMask && 16 * c + 8 * h + 2 * t + e % 2 >= valid) continue;
        mx[e / 2] = fmaxf(mx[e / 2], s[c][h][e]);
      }
    }
  }
  float nm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row's maximum over the quad that holds it
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // key 0 of the tile is a live one, so m_new is finite and m - m_new is -inf at most
    const float m_new = fmaxf(m[i], mx[i] * scale_log2);
    const float corr = exp2_approx(m[i] - m_new);
    l[i] *= corr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * i] *= corr;
      acc[j][2 * i + 1] *= corr;
    }
    m[i] = m_new;
    nm[i] = -m_new;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_approx(fmaf(s[c][h][e], scale_log2, nm[e / 2]));
        if (kMask && 16 * c + 8 * h + 2 * t + e % 2 >= valid) p[e] = 0.f;
        l[e / 2] += p[e];
      }
      a[2 * h] = pack_bf16(p[0], p[1]);
      a[2 * h + 1] = pack_bf16(p[2], p[3]);
    }
    mma_over_rows<D>(acc, a, vs, 16 * c, lane);
  }
}

// At D = 8 (the path's) the forward asks for 8 blocks an SM, at most 64
// registers a thread: the 32 scores of a tile held across the softmax need
// more, and the few bytes that spill cost less than the occupancy they buy,
// which hides the latency of the exponentials and shuffles. Larger D would
// spill much more; they keep the compiler's choice.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 8 ? 8 : 1)
flashattn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                        Strides sq, Strides sk, Strides sv, Strides so, int heads, int q_len,
                        int k_len, int tiles, float scale_log2, bool k_dense, bool v_dense) {
  constexpr int P = tc_pitch<D>();
  __shared__ __align__(16) bf16 ks[2][kTcTile * P];
  __shared__ __align__(16) bf16 vs[2][kTcTile * P];
  const int bh = blockIdx.x / tiles;
  const int n = bh / heads, h = bh % heads;
  const int lane = threadIdx.x % 32, t = lane % 4;
  // this thread's query rows r0 and r0 + 8
  const int r0 = (blockIdx.x % tiles) * kTcRows + (threadIdx.x / 32) * 16 + lane / 4;
  uint32_t qa[D / 4];
  load_a<D>(qa, q + n * sq.n + h * sq.h, sq.d, sq.s, r0, q_len, t);
  if (scale_log2 < 0.f) {
    // q negated (exact in bfloat16), so that the maximum of the raw scores is
    // the maximum of the scaled ones
#pragma unroll
    for (int i = 0; i < D / 4; ++i) qa[i] ^= 0x80008000u;
    scale_log2 = -scale_log2;
  }
  float acc[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* kb = k + n * sk.n + h * sk.h;
  const bf16* vb = v + n * sv.n + h * sv.h;
  const int steps = (k_len + kTcTile - 1) / kTcTile;
  stage_tc<D>(ks[0], kb, sk.d, sk.s, 0, k_len, k_dense);
  stage_tc<D>(vs[0], vb, sv.d, sv.s, 0, k_len, v_dense);
  cp_async_commit();
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < steps) {  // the next tile into the other buffer, freed by the last barrier
      stage_tc<D>(ks[buf ^ 1], kb, sk.d, sk.s, (it + 1) * kTcTile, k_len, k_dense);
      stage_tc<D>(vs[buf ^ 1], vb, sv.d, sv.s, (it + 1) * kTcTile, k_len, v_dense);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int valid = min(kTcTile, k_len - it * kTcTile);
    if (valid == kTcTile)
      fwd_tile<D, false>(acc, m, l, qa, ks[buf], vs[buf], valid, scale_log2);
    else
      fwd_tile<D, true>(acc, m, l, qa, ks[buf], vs[buf], valid, scale_log2);
    __syncthreads();
  }
  bf16* ob = o + n * so.n + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row's sum over the quad, in one order for every lane
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= q_len) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      bf16* p = ob + row * so.s + (8 * j + 2 * t) * so.d;
      p[0] = __float2bfloat16_rn(acc[j][2 * i] * inv);
      p[so.d] = __float2bfloat16_rn(acc[j][2 * i + 1] * inv);
    }
    if (t == 0) lse[static_cast<int64_t>(bh) * q_len + row] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// a (N, H, D, S) view whose rows of D values are dense, 16-byte aligned runs
bool rows_dense(const void* p, const Strides& s) {
  return s.d == 1 && s.s % 8 == 0 && s.h % 8 == 0 && s.n % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
                const int64_t* st, int n, int heads, int q_len, int k_len, float scale,
                cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor cores
    const int tiles = (q_len + kTcRows - 1) / kTcRows;
    const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
    const Strides sk = strides_at(st, 1), sv = strides_at(st, 2);
    flashattn_fwd_tc_kernel<D><<<blocks, kTcThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, strides_at(st, 0), sk, sv, strides_at(st, 3), heads, q_len,
        k_len, tiles, scale * kLog2e, rows_dense(k, sk), rows_dense(v, sv));
  } else {  // float32: the float32 units
    constexpr int R = rows_per_thread<D>();
    const int tiles = tiles_for(q_len, R);
    const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
    flashattn_fwd_kernel<D, R><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
        strides_at(st, 3), heads, q_len, k_len, tiles, scale * kLog2e);
  }
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dq, const int64_t* st, int n, int heads, int q_len,
               int k_len, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor cores
    const int tiles = (q_len + kTcRows - 1) / kTcRows;
    const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
    const Strides sk = strides_at(st, 1), sv = strides_at(st, 2);
    flashattn_dq_tc_kernel<D><<<blocks, kTcThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq), strides_at(st, 0), sk,
        sv, strides_at(st, 3), strides_at(st, 4), heads, q_len, k_len, tiles, scale,
        scale * kLog2e, rows_dense(k, sk), rows_dense(v, sv));
  } else {  // float32: the float32 units
    constexpr int R = rows_per_thread<D>();
    const int tiles = tiles_for(q_len, R);
    const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
    flashattn_dq_kernel<D, R><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), strides_at(st, 0),
        strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), heads, q_len,
        k_len, tiles, scale, scale * kLog2e);
  }
}

// the blocks own keys here: the grid follows k_len
template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* di, void* dk, void* dv, const int64_t* st, int n, int heads,
                int q_len, int k_len, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor cores
    const int tiles = (k_len + kTcRows - 1) / kTcRows;
    const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
    const Strides sq = strides_at(st, 0), sdo = strides_at(st, 3);
    // the gradients asked for choose the instantiation: no branch on them inside
    const auto kernel = dk == nullptr   ? flashattn_dkv_tc_kernel<D, false, true>
                        : dv == nullptr ? flashattn_dkv_tc_kernel<D, true, false>
                                        : flashattn_dkv_tc_kernel<D, true, true>;
    kernel<<<blocks, kTcThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        sq, strides_at(st, 1), strides_at(st, 2), sdo, strides_at(st, 4), strides_at(st, 5),
        heads, q_len, k_len, tiles, scale, scale * kLog2e, rows_dense(q, sq),
        rows_dense(dout, sdo));
  } else {  // float32: the float32 units
    constexpr int R = rows_per_thread<D>();
    const int tiles = tiles_for(k_len, R);
    const unsigned int blocks = static_cast<unsigned int>(n) * heads * tiles;
    flashattn_dkv_kernel<D, R><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, di, static_cast<float*>(dk), static_cast<float*>(dv),
        strides_at(st, 0), strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
        strides_at(st, 4), strides_at(st, 5), heads, q_len, k_len, tiles, scale, scale * kLog2e);
  }
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
// cudaGetLastError(). The queries (q, o, dout, dq) hold q_len rows, the keys (k,
// v, dk, dv) k_len: q_len < k_len is a rank's share of the queries against every
// key (the spatial mesh axis), q_len == k_len the self-attention of one sequence.
// The caller checks: n, heads, q_len, k_len >= 1, d in {8, 16, 32, 64}, n *
// heads * ceil(max(q_len, k_len) / 64) below 2^31, no output overlapping itself.
// dtype: 0 = float32, 1 = bfloat16 (of every view); lse and di are (N, H, q_len)
// float32, contiguous. Every entry takes the float32-unit kernels for float32
// and the tensor-core kernels for bfloat16.

extern "C" int tfcgan_flashattn_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, const int64_t* strides, int n, int heads,
                                    int q_len, int k_len, int d, float scale, int dtype,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!TFCGAN_FLASHATTN_DISPATCH(launch_fwd, q, k, v, o, lse, strides, n, heads, q_len, k_len,
                                 scale, s))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, dout, dq
extern "C" int tfcgan_flashattn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* di,
                                       void* dq, const int64_t* strides, int n, int heads,
                                       int q_len, int k_len, int d, float scale, int dtype,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!TFCGAN_FLASHATTN_DISPATCH(launch_dq, q, k, v, dout, lse, di, dq, strides, n, heads, q_len,
                                 k_len, scale, s))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// strides: q, k, v, dout, dk, dv (a skipped gradient's four are not read). dk or
// dv may be null, not both.
extern "C" int tfcgan_flashattn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* di,
                                        void* dk, void* dv, const int64_t* strides, int n,
                                        int heads, int q_len, int k_len, int d, float scale,
                                        int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk == nullptr && dv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!TFCGAN_FLASHATTN_DISPATCH(launch_dkv, q, k, v, dout, lse, di, dk, dv, strides, n, heads,
                                 q_len, k_len, scale, s))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
