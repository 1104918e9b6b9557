// Flash-attention backward for Hopper (sm_90a): recompute-from-LSE, f32
// accumulation, GQA group sum in f32.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention_bwd.py
// (flash_attention_bwd: _dq_kernel, pallas_call at :161; _dkv_kernel,
// pallas_call at :181).  Like the Pallas function it has a dq launch and a
// dk/dv launch:
//
//  * dq: a block per (q tile, q head, batch) loops over the k tiles its rows
//    see: s = q.k^T * scale (masked -> -1e30), p = exp(s - lse),
//    dp = dout.v^T, ds = p * (dp - delta) * scale, dq += ds.k.  It also
//    computes delta = rowsum(dout * out) for its rows (f32) and writes it to
//    a scratch array the dk/dv launch reads.
//  * dk/dv: for each key tile, over the q tiles that see its keys,
//    dv += p^T.dout, dk += ds^T.q, summed over the kv head's G query heads.
//
// Two implementations share that plan:
//
//  * bf16 / f16 operands (the training path): the products on the tensor
//    cores (WMMA 16x16x16, f32 accumulate) over 64-row tiles.  The dk/dv
//    launch takes a block per (k tile, q HEAD, batch), writes each head's
//    dk, dv in f32 to scratch, and a small third kernel sums each kv head's
//    G heads in a fixed order and casts.  Walking the group inside one block
//    instead gives B * NKV * S / 64 blocks (128 for gemma-2b training) with
//    a G * S / 64 : G causal imbalance between the first and last key tile;
//    the scratch costs 2 * B * NQ * S * D f32 written and read once.
//  * f32 operands: the products in f32 on the CUDA cores, one thread row
//    slice per accumulator, the dk/dv block walking the whole GQA group with
//    dk, dv in registers (no scratch).
//
// The bound on the H100 at the training shape (q (2, 8, 2048, 256), one kv
// head, bf16, causal) is the tensor cores: the function needs five S x S x D
// products (s, dp, dv, dq, dk), ~84 GFLOP causal, against ~76 MB of
// operands.  This two-launch design recomputes s and dp in the dq launch
// (seven products), stages tiles through shared memory without
// asynchronous copies, and runs one 256-thread block per SM; wgmma, TMA and
// a fused single-pass backward come later.  Whole tiles outside the causal /
// window band are skipped exactly as in the forward kernel.
//
// Head dims 16, 32, 64, 80, 96, 128, 256 (80 and 96 are whole 16-wide WMMA
// tiles); shared memory at D = 96: 107,008 bytes (tensor cores), 115,968
// (dq) and 133,120 (dk/dv) on the CUDA cores, under the 227 KB a block may
// use.
//
// Semantics match the Pallas kernels: the finite sentinel -1e30 for masked
// scores, p = exp(s - lse).  Unlike the Pallas kernels, S need not be a
// multiple of a tile: keys and queries past S get p = 0 and rows past S are
// not stored.  Operands are addressed through (batch, head, seq) element
// strides, so the model's (B, S, N, HD) activations are read in place.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* out;   // dq kernel only
  const void* dout;
  const float* lse;  // (B, NQ, S) contiguous
  float* delta;      // (B, NQ, S) contiguous: written by dq, read by dkv
  void* dq;
  void* dk;
  void* dv;
  int NQ, G, S;
  Strides3 qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  bool ok = true;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  return ok;
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32 operands).
// dq: a block per (q tile of kDqBQ rows, q head, batch), 4 threads per row.
// ---------------------------------------------------------------------------
constexpr int kDqBQ = 64;
constexpr int kDqLanes = kThreads / kDqBQ;  // 4 adjacent lanes of a warp

template <int D>
struct DqTile {
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr int smem_floats = 2 * kDqBQ * (D + 1) + 2 * BK * (D + 1) + kDqBQ * (BK + 1);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int BK = DqTile<D>::BK;
  constexpr int CPT = BK / kDqLanes;  // score columns per thread
  constexpr int DPT = D / kDqLanes;   // dq features per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kDqBQ][D + 1]  (+1: no bank conflicts)
  float* do_s = q_s + kDqBQ * (D + 1);  // [kDqBQ][D + 1]
  float* k_s = do_s + kDqBQ * (D + 1);  // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);      // [BK][D + 1]
  float* ds_s = v_s + BK * (D + 1);     // [kDqBQ][BK + 1]

  const int S = a.S;
  const int q0 = blockIdx.x * kDqBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x;
  const int row = tid / kDqLanes;
  const int lane = tid % kDqLanes;
  const int qpos = q0 + row;
  const bool row_in = qpos < S;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* ob = static_cast<const T*>(a.out) + b * a.os.b + h * a.os.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;

  for (int i = tid; i < kDqBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    const bool in = s < S;
    q_s[r * (D + 1) + d] = in ? to_f32(qb[(long long)s * a.qs.s + d]) : 0.f;
    do_s[r * (D + 1) + d] = in ? to_f32(dob[(long long)s * a.dos.s + d]) : 0.f;
  }
  __syncthreads();

  const float* qr = q_s + row * (D + 1);
  const float* dor = do_s + row * (D + 1);
  float* dsr = ds_s + row * (BK + 1);

  // delta = rowsum(dout * out) in f32, shared with the dk/dv launch.
  float delta = 0.f;
  if (row_in) {
    const T* orow = ob + (long long)qpos * a.os.s;
#pragma unroll 4
    for (int j = 0; j < DPT; ++j) {
      const int d = lane + kDqLanes * j;
      delta += dor[d] * to_f32(orow[d]);
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  const long long lrow = ((long long)b * a.NQ + h) * S + qpos;
  const float lse = row_in ? a.lse[lrow] : 0.f;
  if (row_in && lane == 0) a.delta[lrow] = delta;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  // Key tiles this query tile sees (whole tiles outside the band skipped).
  int kt_begin = 0;
  int kt_end = (S + BK - 1) / BK;
  if (a.causal) kt_end = min(kt_end, (min(q0 + kDqBQ, S) - 1) / BK + 1);
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;  // the smallest key the first row sees
    if (lo > 0) kt_begin = lo / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D, d = i % D, s = k0 + c;
      const bool in = s < S;
      k_s[c * (D + 1) + d] = in ? to_f32(kb[(long long)s * a.ks.s + d]) : 0.f;
      v_s[c * (D + 1) + d] = in ? to_f32(vb[(long long)s * a.vs.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[CPT], dp[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) sc[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], dd = dor[d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = lane + kDqLanes * j;
        sc[j] += qd * k_s[c * (D + 1) + d];
        dp[j] += dd * v_s[c * (D + 1) + d];
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = lane + kDqLanes * j;
      const int kpos = k0 + c;
      const float s = visible(qpos, kpos, a.causal, a.window) ? sc[j] * a.scale : kNegInf;
      const float p = (row_in && kpos < S) ? expf(s - lse) : 0.f;
      dsr[c] = p * (dp[j] - delta) * a.scale;
    }
    __syncwarp();  // the row's four writers share this warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = dsr[c];
      const float* kr = k_s + c * (D + 1);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += ds * kr[lane + kDqLanes * j];
    }
  }

  if (row_in) {
    T* dqrow = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h + (long long)qpos * a.dqs.s;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dqrow[lane + kDqLanes * j] = from_f32<T>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: a block per (k tile of BK rows, kv head, batch), kThreads / BK
// threads per key row, looping over the G query heads and their q tiles.
// ---------------------------------------------------------------------------
template <int D>
struct DkvTile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // key rows per block
  static constexpr int BQ = D >= 256 ? 32 : 64;  // query rows per inner tile
  static constexpr int smem_floats =
      2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdArgs a) {
  constexpr int BK = DkvTile<D>::BK;
  constexpr int BQ = DkvTile<D>::BQ;
  constexpr int LANES = kThreads / BK;  // adjacent lanes per key row
  constexpr int CPT = BQ / LANES;       // score columns (query rows) per thread
  constexpr int DPT = D / LANES;        // dk / dv features per thread
  extern __shared__ float smem[];
  float* k_s = smem;                   // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);     // [BK][D + 1]
  float* q_s = v_s + BK * (D + 1);     // [BQ][D + 1]
  float* do_s = q_s + BQ * (D + 1);    // [BQ][D + 1]
  float* p_s = do_s + BQ * (D + 1);    // [BK][BQ + 1]
  float* ds_s = p_s + BK * (BQ + 1);   // [BK][BQ + 1]
  float* lse_s = ds_s + BK * (BQ + 1); // [BQ]
  float* dl_s = lse_s + BQ;            // [BQ]

  const int S = a.S;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int kpos = k0 + row;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  for (int i = tid; i < BK * D; i += kThreads) {
    const int c = i / D, d = i % D, s = k0 + c;
    const bool in = s < S;
    k_s[c * (D + 1) + d] = in ? to_f32(kb[(long long)s * a.ks.s + d]) : 0.f;
    v_s[c * (D + 1) + d] = in ? to_f32(vb[(long long)s * a.vs.s + d]) : 0.f;
  }

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.f;

  // Query tiles that see this key tile (whole tiles outside the band skipped).
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt_begin = a.causal ? k0 / BQ : 0;
  int qt_end = n_qt;
  if (a.window > 0) {
    const int hi = min(k0 + BK, S) - 1 + a.window - 1;  // the largest query the last key reaches
    qt_end = min(n_qt, hi / BQ + 1);
  }

  const float* kr = k_s + row * (D + 1);
  const float* vr = v_s + row * (D + 1);
  float* pr = p_s + row * (BQ + 1);
  float* dsr = ds_s + row * (BQ + 1);

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
    const long long lbase = ((long long)b * a.NQ + h) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int r = i / D, d = i % D, s = q0 + r;
        const bool in = s < S;
        q_s[r * (D + 1) + d] = in ? to_f32(qb[(long long)s * a.qs.s + d]) : 0.f;
        do_s[r * (D + 1) + d] = in ? to_f32(dob[(long long)s * a.dos.s + d]) : 0.f;
      }
      for (int r = tid; r < BQ; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? a.lse[lbase + q0 + r] : 0.f;
        dl_s[r] = in ? a.delta[lbase + q0 + r] : 0.f;
      }
      __syncthreads();

      float sc[CPT], dp[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int r = lane + LANES * j;
          sc[j] += kd * q_s[r * (D + 1) + d];
          dp[j] += vd * do_s[r * (D + 1) + d];
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int r = lane + LANES * j;
        const int qpos = q0 + r;
        const float s = visible(qpos, kpos, a.causal, a.window) ? sc[j] * a.scale : kNegInf;
        const float p = qpos < S ? expf(s - lse_s[r]) : 0.f;
        pr[r] = p;
        dsr[r] = p * (dp[j] - dl_s[r]) * a.scale;
      }
      __syncwarp();  // the row's writers share this warp

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float p = pr[r], ds = dsr[r];
        const float* dor = do_s + r * (D + 1);
        const float* qr = q_s + r * (D + 1);
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const int d = lane + LANES * j;
          dv[j] += p * dor[d];
          dk[j] += ds * qr[d];
        }
      }
    }
  }

  if (kpos < S) {
    T* dkrow = static_cast<T*>(a.dk) + b * a.dks.b + kvh * a.dks.h + (long long)kpos * a.dks.s;
    T* dvrow = static_cast<T*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h + (long long)kpos * a.dvs.s;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dkrow[lane + LANES * j] = from_f32<T>(dk[j]);
      dvrow[lane + LANES * j] = from_f32<T>(dv[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 / f16 operands), as the header describes.  p and
// ds are rounded to the operand dtype before their products, as
// FlashAttention-2 does; s, dp, delta, the softmax and every accumulator
// stay f32.
// ---------------------------------------------------------------------------
constexpr int kTcB = 64;            // rows of every q and k tile
constexpr int kTcWarps = kThreads / 32;
constexpr int kSL = kTcB + 4;       // f32 score-tile leading dim
constexpr int kPL = kTcB + 8;       // 16-bit score-tile leading dim

template <int D>
struct TcTile {
  static constexpr int L = D + 8;   // 16-bit operand-tile leading dim (ldmatrix conflict-free)
  static constexpr int FL = D + 4;  // f32 staging leading dim
  static constexpr int NF = 4 * (D / 16);          // 16x16 output fragments of a 64 x D tile
  static constexpr int FPW = (NF + kTcWarps - 1) / kTcWarps;
  // Four 64 x L operand tiles, two f32 score tiles, two 16-bit score tiles, lse + delta.
  static constexpr int smem_bytes =
      4 * kTcB * L * 2 + 2 * kTcB * kSL * 4 + 2 * kTcB * kPL * 2 + 2 * kTcB * 4;
};

// rows x D tile of a (seq, feature) operand into shared memory (row leading
// dim L); rows past S read as zero.  ``vec``: 16-byte loads (the host has
// checked the pointer and strides are 16-byte aligned).
template <typename T, int D, int L>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int s0, int S,
                                          bool vec) {
  if (vec) {
    constexpr int C = D / 8;
    for (int i = threadIdx.x; i < kTcB * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 8, s = s0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (s < S) x = *reinterpret_cast<const uint4*>(src + (long long)s * stride + c);
      *reinterpret_cast<uint4*>(dst + r * L + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < kTcB * D; i += kThreads) {
      const int r = i / D, d = i % D, s = s0 + r;
      dst[r * L + d] = s < S ? src[(long long)s * stride + d] : from_f32<T>(0.f);
    }
  }
}

// Two 64 x 64 products sharing their operands' rows: sa = A.B^T, sb = C.E^T
// (A, C: 64 x D row-major; B, E: 64 x D row-major, read as col-major B^T),
// each warp computing fragments (w % 4, w / 4) and (w % 4, w / 4 + 2), stored
// f32 to sa_s / sb_s.
template <typename T, int D>
__device__ __forceinline__ void scores_tc(const T* A, const T* Bm, const T* C, const T* E,
                                          float* sa_s, float* sb_s) {
  using namespace nvcuda;
  constexpr int L = TcTile<D>::L;
  const int w = threadIdx.x / 32;
  const int rb = w % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> sa[2], sb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    wmma::fill_fragment(sa[i], 0.f);
    wmma::fill_fragment(sb[i], 0.f);
  }
#pragma unroll 4
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa, fc;
    wmma::load_matrix_sync(fa, A + rb * 16 * L + kk * 16, L);
    wmma::load_matrix_sync(fc, C + rb * 16 * L + kk * 16, L);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cb = w / 4 + 2 * i;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb, fe;
      wmma::load_matrix_sync(fb, Bm + cb * 16 * L + kk * 16, L);
      wmma::load_matrix_sync(fe, E + cb * 16 * L + kk * 16, L);
      wmma::mma_sync(sa[i], fa, fb, sa[i]);
      wmma::mma_sync(sb[i], fc, fe, sb[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int cb = w / 4 + 2 * i;
    wmma::store_matrix_sync(sa_s + rb * 16 * kSL + cb * 16, sa[i], kSL, wmma::mem_row_major);
    wmma::store_matrix_sync(sb_s + rb * 16 * kSL + cb * 16, sb[i], kSL, wmma::mem_row_major);
  }
}

// acc[i] += P.X for the warp's output fragments (row block w % 4, column
// block w / 4 + 2 i) of a 64 x D product; P: 64 x 64 (leading dim kPL), X:
// 64 x D (leading dim L), both row-major in shared memory.
template <typename T, int D, int N>
__device__ __forceinline__ void accumulate_tc(
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[N],
    const T* P, const T* X) {
  using namespace nvcuda;
  constexpr int L = TcTile<D>::L;
  const int w = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < kTcB / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fp;
    wmma::load_matrix_sync(fp, P + (w % 4) * 16 * kPL + kk * 16, kPL);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int f = w + kTcWarps * i;
      if (f >= TcTile<D>::NF) break;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fx;
      wmma::load_matrix_sync(fx, X + kk * 16 * L + (f / 4) * 16, L);
      wmma::mma_sync(acc[i], fp, fx, acc[i]);
    }
  }
}

// The warp's fragments of a 64 x D accumulator into f32 staging (leading
// dim FL).
template <int D, int N>
__device__ __forceinline__ void stage_tc(
    float* stg, nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[N]) {
  using namespace nvcuda;
  constexpr int FL = TcTile<D>::FL;
  const int w = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int f = w + kTcWarps * i;
    if (f >= TcTile<D>::NF) break;
    wmma::store_matrix_sync(stg + (f % 4) * 16 * FL + (f / 4) * 16, acc[i], FL,
                            wmma::mem_row_major);
  }
}

struct TcArgs {
  BwdArgs a;
  float* dk_part;  // (B, NQ, S, D) f32 scratch, or null when G == 1
  float* dv_part;
  int vec;         // every operand 16-byte aligned with 16-byte row strides
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(TcArgs t) {
  using namespace nvcuda;
  using Tile = TcTile<D>;
  constexpr int L = Tile::L, FL = Tile::FL;
  const BwdArgs& a = t.a;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [64][L]
  T* do_s = q_s + kTcB * L;                  // [64][L]
  T* k_s = do_s + kTcB * L;                  // [64][L]
  T* v_s = k_s + kTcB * L;                   // [64][L]
  float* s_s = reinterpret_cast<float*>(v_s + kTcB * L);  // [64][kSL]
  float* dp_s = s_s + kTcB * kSL;                         // [64][kSL]
  T* ds_s = reinterpret_cast<T*>(dp_s + kTcB * kSL);      // [64][kPL]
  float* lse_s = reinterpret_cast<float*>(ds_s + 2 * kTcB * kPL);
  float* dl_s = lse_s + kTcB;

  const int S = a.S;
  const int q0 = blockIdx.x * kTcB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* ob = static_cast<const T*>(a.out) + b * a.os.b + h * a.os.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  load_tile<T, D, L>(q_s, qb, a.qs.s, q0, S, t.vec);
  load_tile<T, D, L>(do_s, dob, a.dos.s, q0, S, t.vec);
  __syncthreads();

  // delta = rowsum(dout * out) in f32, 4 lanes per row; shared with dk/dv.
  {
    const int row = tid / 4, lane = tid % 4, qpos = q0 + row;
    float delta = 0.f;
    if (qpos < S) {
      const T* orow = ob + (long long)qpos * a.os.s;
      for (int d = lane; d < D; d += 4) delta += to_f32(do_s[row * L + d]) * to_f32(orow[d]);
    }
    delta += __shfl_xor_sync(0xffffffffu, delta, 1);
    delta += __shfl_xor_sync(0xffffffffu, delta, 2);
    const long long lrow = ((long long)b * a.NQ + h) * S + qpos;
    if (lane == 0) {
      dl_s[row] = delta;
      lse_s[row] = qpos < S ? a.lse[lrow] : 0.f;
      if (qpos < S) a.delta[lrow] = delta;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Tile::FPW];
#pragma unroll
  for (int i = 0; i < Tile::FPW; ++i) wmma::fill_fragment(acc[i], 0.f);

  int kt_begin = 0;
  int kt_end = (S + kTcB - 1) / kTcB;
  if (a.causal) kt_end = min(kt_end, (min(q0 + kTcB, S) - 1) / kTcB + 1);
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;
    if (lo > 0) kt_begin = lo / kTcB;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTcB;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, L>(k_s, kb, a.ks.s, k0, S, t.vec);
    load_tile<T, D, L>(v_s, vb, a.vs.s, k0, S, t.vec);
    __syncthreads();
    scores_tc<T, D>(q_s, k_s, do_s, v_s, s_s, dp_s);  // s = q.k^T, dp = dout.v^T
    __syncthreads();
    for (int i = tid; i < kTcB * kTcB; i += kThreads) {
      const int r = i / kTcB, c = i % kTcB, qpos = q0 + r, kpos = k0 + c;
      const float s = visible(qpos, kpos, a.causal, a.window) ? s_s[r * kSL + c] * a.scale
                                                              : kNegInf;
      const float p = (qpos < S && kpos < S) ? expf(s - lse_s[r]) : 0.f;
      ds_s[r * kPL + c] = from_f32<T>(p * (dp_s[r * kSL + c] - dl_s[r]) * a.scale);
    }
    __syncthreads();
    accumulate_tc<T, D>(acc, ds_s, k_s);  // dq += ds.k
  }

  __syncthreads();  // q_s / do_s become the f32 staging tile
  float* stg = reinterpret_cast<float*>(q_s);
  stage_tc<D>(stg, acc);
  __syncthreads();
  T* dqb = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
  for (int i = tid; i < kTcB * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    if (s < S) dqb[(long long)s * a.dqs.s + d] = from_f32<T>(stg[r * FL + d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(TcArgs t) {
  using namespace nvcuda;
  using Tile = TcTile<D>;
  constexpr int L = Tile::L, FL = Tile::FL;
  const BwdArgs& a = t.a;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [64][L]
  T* v_s = k_s + kTcB * L;                   // [64][L]
  T* q_s = v_s + kTcB * L;                   // [64][L]
  T* do_s = q_s + kTcB * L;                  // [64][L]
  float* st_s = reinterpret_cast<float*>(do_s + kTcB * L);  // [64 keys][kSL]: s^T
  float* dpt_s = st_s + kTcB * kSL;                          // dp^T
  T* pt_s = reinterpret_cast<T*>(dpt_s + kTcB * kSL);        // [64][kPL]: p^T
  T* dst_s = pt_s + kTcB * kPL;                              // ds^T
  float* lse_s = reinterpret_cast<float*>(dst_s + kTcB * kPL);
  float* dl_s = lse_s + kTcB;

  const int S = a.S;
  const int k0 = blockIdx.x * kTcB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* dob = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const long long lbase = ((long long)b * a.NQ + h) * S;
  load_tile<T, D, L>(k_s, kb, a.ks.s, k0, S, t.vec);
  load_tile<T, D, L>(v_s, vb, a.vs.s, k0, S, t.vec);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[Tile::FPW], dv[Tile::FPW];
#pragma unroll
  for (int i = 0; i < Tile::FPW; ++i) {
    wmma::fill_fragment(dk[i], 0.f);
    wmma::fill_fragment(dv[i], 0.f);
  }

  const int n_qt = (S + kTcB - 1) / kTcB;
  const int qt_begin = a.causal ? k0 / kTcB : 0;
  int qt_end = n_qt;
  if (a.window > 0) {
    const int hi = min(k0 + kTcB, S) - 1 + a.window - 1;
    qt_end = min(n_qt, hi / kTcB + 1);
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kTcB;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, L>(q_s, qb, a.qs.s, q0, S, t.vec);
    load_tile<T, D, L>(do_s, dob, a.dos.s, q0, S, t.vec);
    for (int r = tid; r < kTcB; r += kThreads) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? a.lse[lbase + q0 + r] : 0.f;
      dl_s[r] = in ? a.delta[lbase + q0 + r] : 0.f;
    }
    __syncthreads();
    scores_tc<T, D>(k_s, q_s, v_s, do_s, st_s, dpt_s);  // s^T = k.q^T, dp^T = v.dout^T
    __syncthreads();
    for (int i = tid; i < kTcB * kTcB; i += kThreads) {
      const int c = i / kTcB, r = i % kTcB, kpos = k0 + c, qpos = q0 + r;
      const float s = visible(qpos, kpos, a.causal, a.window) ? st_s[c * kSL + r] * a.scale
                                                              : kNegInf;
      const float p = (qpos < S && kpos < S) ? expf(s - lse_s[r]) : 0.f;
      pt_s[c * kPL + r] = from_f32<T>(p);
      dst_s[c * kPL + r] = from_f32<T>(p * (dpt_s[c * kSL + r] - dl_s[r]) * a.scale);
    }
    __syncthreads();
    accumulate_tc<T, D>(dv, pt_s, do_s);  // dv += p^T.dout
    accumulate_tc<T, D>(dk, dst_s, q_s);  // dk += ds^T.q
  }

  // dk then dv through the f32 staging tile (over q_s / do_s): straight to
  // the output when the group is one head, else to this head's f32 scratch.
  float* stg = reinterpret_cast<float*>(q_s);
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
    stage_tc<D>(stg, which == 0 ? dk : dv);
    __syncthreads();
    float* part = which == 0 ? t.dk_part : t.dv_part;
    if (part != nullptr) {
      float* pb = part + lbase * D;
      for (int i = tid; i < kTcB * D; i += kThreads) {
        const int r = i / D, d = i % D, s = k0 + r;
        if (s < S) pb[(long long)s * D + d] = stg[r * FL + d];
      }
    } else {
      const Strides3& os = which == 0 ? a.dks : a.dvs;
      T* ob = static_cast<T*>(which == 0 ? a.dk : a.dv) + b * os.b + kvh * os.h;
      for (int i = tid; i < kTcB * D; i += kThreads) {
        const int r = i / D, d = i % D, s = k0 + r;
        if (s < S) ob[(long long)s * os.s + d] = from_f32<T>(stg[r * FL + d]);
      }
    }
  }
}

// dk[b, kvh] = sum over g of dk_part[b, kvh * G + g] (in order g = 0..G-1,
// f32), cast to T; the same for dv.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_group_sum_kernel(TcArgs t, int NKV, int D,
                                                                       long long total) {
  const BwdArgs& a = t.a;
  const long long SD = (long long)a.S * D;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int d = (int)(i % D);
    const int s = (int)((i / D) % a.S);
    const int kvh = (int)((i / SD) % NKV);
    const int b = (int)(i / (SD * NKV));
    const long long src = ((long long)b * a.NQ + (long long)kvh * a.G) * SD + (long long)s * D + d;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < a.G; ++g) {
      sk += t.dk_part[src + g * SD];
      sv += t.dv_part[src + g * SD];
    }
    static_cast<T*>(a.dk)[b * a.dks.b + kvh * a.dks.h + (long long)s * a.dks.s + d] = from_f32<T>(sk);
    static_cast<T*>(a.dv)[b * a.dvs.b + kvh * a.dvs.h + (long long)s * a.dvs.s + d] = from_f32<T>(sv);
  }
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = DqTile<D>::smem_floats * (int)sizeof(float);
  static_assert(smem <= 232448, "shared memory over the 227 KB a block may use");
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + kDqBQ - 1) / kDqBQ, a.NQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, int B, int NKV, cudaStream_t stream) {
  constexpr int smem = DkvTile<D>::smem_floats * (int)sizeof(float);
  static_assert(smem <= 232448, "shared memory over the 227 KB a block may use");
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + DkvTile<D>::BK - 1) / DkvTile<D>::BK, NKV, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tc(bool dkv, const TcArgs& t, int B, int NKV, cudaStream_t stream) {
  constexpr int smem = TcTile<D>::smem_bytes;
  static_assert(smem <= 232448, "shared memory over the 227 KB a block may use");
  auto kernel = dkv ? flash_bwd_dkv_tc_kernel<T, D> : flash_bwd_dq_tc_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t.a.S + kTcB - 1) / kTcB, t.a.NQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dkv || t.dk_part == nullptr) return err;
  const long long total = (long long)B * NKV * t.a.S * D;
  const int blocks = (int)std::min<long long>((total + kThreads - 1) / kThreads, 1 << 16);
  flash_bwd_group_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(t, NKV, D, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(bool dkv, int D, const TcArgs& t, int B, int NKV, cudaStream_t st) {
  const BwdArgs& a = t.a;
  if constexpr (std::is_same<T, float>::value) {  // f32 operands: the CUDA-core kernels
    switch (D) {
      case 16: return dkv ? launch_dkv<T, 16>(a, B, NKV, st) : launch_dq<T, 16>(a, B, st);
      case 32: return dkv ? launch_dkv<T, 32>(a, B, NKV, st) : launch_dq<T, 32>(a, B, st);
      case 80: return dkv ? launch_dkv<T, 80>(a, B, NKV, st) : launch_dq<T, 80>(a, B, st);
      case 96: return dkv ? launch_dkv<T, 96>(a, B, NKV, st) : launch_dq<T, 96>(a, B, st);
      case 64: return dkv ? launch_dkv<T, 64>(a, B, NKV, st) : launch_dq<T, 64>(a, B, st);
      case 128: return dkv ? launch_dkv<T, 128>(a, B, NKV, st) : launch_dq<T, 128>(a, B, st);
      case 256: return dkv ? launch_dkv<T, 256>(a, B, NKV, st) : launch_dq<T, 256>(a, B, st);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 16: return launch_tc<T, 16>(dkv, t, B, NKV, st);
      case 32: return launch_tc<T, 32>(dkv, t, B, NKV, st);
      case 80: return launch_tc<T, 80>(dkv, t, B, NKV, st);
      case 96: return launch_tc<T, 96>(dkv, t, B, NKV, st);
      case 64: return launch_tc<T, 64>(dkv, t, B, NKV, st);
      case 128: return launch_tc<T, 128>(dkv, t, B, NKV, st);
      case 256: return launch_tc<T, 256>(dkv, t, B, NKV, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

// Whether every operand row can be read with 16-byte loads.
bool aligned16(const void* const* ptrs, int n_ptrs, const Strides3* strides, int n_strides,
               int elem) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i) {
    const Strides3& st = strides[i];
    if ((st.b * elem) % 16 || (st.h * elem) % 16 || (st.s * elem) % 16) return false;
  }
  return true;
}

int run(bool dkv, TcArgs& t, int dtype, int B, int NKV, int D, void* stream) {
  const BwdArgs& a = t.a;
  if (B <= 0 || a.NQ <= 0 || NKV <= 0 || a.S <= 0 || a.NQ % NKV != 0)
    return (int)cudaErrorInvalidValue;
  if (dkv && dtype != kF32 && a.G > 1 && (t.dk_part == nullptr || t.dv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.G == 1) t.dk_part = t.dv_part = nullptr;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, dkv ? a.q : a.out};
  const Strides3 strides[] = {a.qs, a.ks, a.vs, a.dos, dkv ? a.qs : a.os};
  t.vec = aligned16(ptrs, 5, strides, 5, dtype == kF32 ? 4 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)dispatch_d<float>(dkv, D, t, B, NKV, st);
    case kBF16: return (int)dispatch_d<__nv_bfloat16>(dkv, D, t, B, NKV, st);
    case kF16: return (int)dispatch_d<__half>(dkv, D, t, B, NKV, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::BwdArgs;
using repro_torch::Strides3;
using repro_torch::TcArgs;

// q, out, dout, dq: (B, NQ, S, D); k, v: (B, NKV, S, D); all addressed
// through the given element strides (feature dim contiguous).  lse and
// delta: (B, NQ, S) f32, contiguous; delta is written here.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* delta, void* dq, int dtype, int B, int NQ, int NKV, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    int causal, int window, float scale, void* stream) {
  if (NKV <= 0 || NQ % NKV != 0) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.NQ = NQ; a.G = NQ / NKV; a.S = S;
  a.qs = Strides3{q_sb, q_sh, q_ss};
  a.ks = Strides3{k_sb, k_sh, k_ss};
  a.vs = Strides3{v_sb, v_sh, v_ss};
  a.os = Strides3{o_sb, o_sh, o_ss};
  a.dos = Strides3{do_sb, do_sh, do_ss};
  a.dqs = Strides3{dq_sb, dq_sh, dq_ss};
  a.causal = causal; a.window = window; a.scale = scale;
  TcArgs t{a, nullptr, nullptr, 0};
  return repro_torch::run(false, t, dtype, B, NKV, D, stream);
}

// Same layouts; dk, dv: (B, NKV, S, D) through strides.  Reads the delta
// written by flash_attention_bwd_dq on the same stream.  dk_part, dv_part:
// (B, NQ, S, D) f32 scratch, needed for bf16 / f16 operands when NQ > NKV
// (else ignored; may be null).
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* dk_part, void* dv_part, int dtype, int B,
    int NQ, int NKV, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  if (NKV <= 0 || NQ % NKV != 0) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = const_cast<float*>(static_cast<const float*>(delta));
  a.dk = dk; a.dv = dv;
  a.NQ = NQ; a.G = NQ / NKV; a.S = S;
  a.qs = Strides3{q_sb, q_sh, q_ss};
  a.ks = Strides3{k_sb, k_sh, k_ss};
  a.vs = Strides3{v_sb, v_sh, v_ss};
  a.dos = Strides3{do_sb, do_sh, do_ss};
  a.dks = Strides3{dk_sb, dk_sh, dk_ss};
  a.dvs = Strides3{dv_sb, dv_sh, dv_ss};
  a.causal = causal; a.window = window; a.scale = scale;
  TcArgs t{a, static_cast<float*>(dk_part), static_cast<float*>(dv_part), 0};
  return repro_torch::run(true, t, dtype, B, NKV, D, stream);
}
