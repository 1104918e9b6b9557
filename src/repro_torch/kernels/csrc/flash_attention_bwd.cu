// Flash-attention backward for Hopper (sm_90a): recompute-from-LSE, f32
// accumulation, GQA group sum in f32.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention_bwd.py
// (flash_attention_bwd: _dq_kernel, pallas_call at :161; _dkv_kernel,
// pallas_call at :181).  Like the Pallas function it has a dq pass and a
// dk/dv pass:
//
//  * dq: for each q tile, over the k tiles its rows see: s = q.k^T * scale
//    (masked -> -1e30), p = exp(s - lse), dp = dout.v^T,
//    ds = p * (dp - delta) * scale, dq += ds.k, with delta = rowsum(dout *
//    out) in f32.
//  * dk/dv: for each key tile, over the q tiles that see its keys,
//    dv += p^T.dout, dk += ds^T.q, summed over the kv head's G query heads.
//
// Three implementations, chosen by the wrapper's ``bwd_route`` from the
// dtype and head dim:
//
//  * "wgmma": bf16 / f16 at D = 64, 128, 256, every full-width train shape
//    but phi3-mini's D = 96 (namespace tcb, below).
//  * "wmma": bf16 / f16 at D = 16, 32, 80, 96 (80 and 96 are not whole
//    64-wide swizzle boxes, as in the forward): WMMA 16x16x16 over 64-row
//    tiles staged by the threads; the dk/dv launch works per q head into
//    (B, NQ, S, D) f32 scratch that a third kernel sums per kv head.
//  * "cuda_core": f32 at any D, the products in f32 FMAs; the dk/dv block
//    walks the whole GQA group with dk, dv in registers.
//
// Bound on the H100, at the gemma-2b train shape q (2, 8, 2048, 256), one kv
// head, bf16, causal: operations.  The function needs five S x S x D
// products (s, dp, dv, dq, dk) over the causal pairs, 5 x 2 D x B NQ x
// S(S+1)/2 = 86 GFLOP: 0.0869 ms at 989 TFLOP/s, against ~76 MB of operands
// (0.023 ms at 3.35 TB/s).
//
// What the "wgmma" design does about it.  Three launches, no atomics,
// bitwise stable from run to run:
//  1. prep: lse * log2(e) and delta = rowsum(dout * out) (f32, one warp a
//     row, fixed shuffle order) into (B, NQ, S_pad) scratch, zero past S.
//  2. one grid of both passes, the dk/dv blocks first, so the dq blocks
//     fill the SMs the dk/dv pass's causal tail leaves idle:
//     * dk/dv: a block per (key tile, head group, kv head, batch), the key
//       tiles of the causal band's longest first.  K and V are TMA-loaded
//       once; one thread of a producer warpgroup streams the group's Q and
//       dout tiles with their LSE and delta rows through an mbarrier ring.
//       S^T = K.Q^T and dP^T = V.dout^T are SS wgmma m64n64k16 (both
//       operands K-major in shared memory); P^T and dS^T stay in registers,
//       rounded to T, as the A operand of dV += P^T.dout and dK += dS^T.Q
//       (wgmma m64n{64,128}k16, dout / Q the MN-major B operand through the
//       transpose bit, as the forward's P.V), then dV += R^T.dout with R
//       P's rounding remainder rounded to T (an early key's few terms with
//       p near 1 do not average P's rounding away); f32 accumulators across
//       every head and q tile of the group.  Head groups: the fewest that fill the
//       card's SMs (``bwd_plan``); one group writes dk / dv directly, more
//       write f32 partials (n_groups, B, NKV, S, D).
//     * dq: a block per (q tile, q head, batch), the last tiles first: Q,
//       dout and the rows' LSE / delta loaded once, K and V streamed;
//       S = Q.K^T and dP = dout.V^T SS wgmma, dQ += dS.K with dS in
//       registers.
//  3. merge (more than one group only): the partials summed in group order
//     and cast (no per-q-head scratch).
// So the design does eight products (s and dp twice, dv in two parts), a
// floor of 0.1391 ms.
// Whole tiles outside the causal / window band are skipped exactly as in the
// forward; masks are applied only on tiles that straddle the band or S.
//
// Occupancy.  One block of three warpgroups (384 threads) per SM: the
// producer drops to 24 registers (setmaxnreg), the two consumer warpgroups
// rise to 240.  At D = 128 / 256 the two consumers share 64 fixed rows and
// split the D columns: warpgroup 0 computes S (and P), warpgroup 1 dP, they
// swap them through shared memory (32 f32 a thread, 32 KB) between two
// named barriers, and each accumulates half of dQ, or of dK and dV: at D =
// 256 that is 2 x 64 f32 accumulators a thread, where a whole 64 x 256 dK
// and dV would take 256.  At D = 64 each consumer owns 64 rows (128 a block)
// and computes both scores.  Shared memory at D = 256: A1 + A2 64 KB, a
// 2-stage ring of B1 + B2 128 KB, LSE / delta 1 KB, the swap 32 KB: 231,464
// bytes of the 232,448 a block may use; D = 128: 3 stages, D = 64: 4.
//
// Head dims 16, 32, 64, 80, 96, 128, 256 (WMMA: 16, 32, 80, 96); shared
// memory at D = 96: 107,008 bytes (WMMA), 115,968 (dq) and 133,120 (dk/dv)
// on the CUDA cores.
//
// Semantics match the Pallas kernels: the finite sentinel -1e30 for masked
// scores, p = exp(s - lse).  Unlike the Pallas kernels, S need not be a
// multiple of a tile: keys and queries past S get p = 0 (TMA fills their
// rows with zeros) and rows past S are not stored.  Operands are addressed
// through (batch, head, seq) element strides, so the model's (B, S, N, HD)
// activations are read in place; the wgmma route needs TMA's 16-byte
// aligned bases and strides (the wrapper raises otherwise).
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

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
  } else {  // 16-bit at D = 64 / 128 / 256 take the wgmma route (tcb)
    switch (D) {
      case 16: return launch_tc<T, 16>(dkv, t, B, NKV, st);
      case 32: return launch_tc<T, 32>(dkv, t, B, NKV, st);
      case 80: return launch_tc<T, 80>(dkv, t, B, NKV, st);
      case 96: return launch_tc<T, 96>(dkv, t, B, NKV, st);
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

// ===========================================================================
// Hopper tensor-core path: bf16 / f16 at D = 64, 128, 256 (wgmma + TMA), as
// the header describes.  One kernel template serves both passes: a block
// owns a tile of "fixed" rows (its q rows for dq; its keys for dk / dv),
// whose two operands A1, A2 (Q and dout, or K and V) TMA loads once, and
// streams 64-row tiles of the other two operands B1, B2 (K and V, or Q and
// dout, with the q rows' LSE and delta) through an mbarrier ring:
//
//   dq pass:    S   = Q.K^T,  dP   = dout.V^T,  dQ += dS.K
//   dk/dv pass: S^T = K.Q^T,  dP^T = V.dout^T,  dK += dS^T.Q,  dV += P^T.dout
//
// so acc0 += dS.B1 in both passes and acc1 += P.B2 in the dk / dv pass.
// ===========================================================================
namespace tcb {

using namespace hopper;

constexpr int kTile = 64;                            // rows of a streamed tile
constexpr int kConsumerWarps = 8;                    // two consumer warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;                    // 128 * 24 + 256 * 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInfL2 = kNegInf * kLog2e;  // the sentinel in log2 units

// kSplit (D = 128, 256): the two consumer warpgroups share 64 fixed rows;
// warpgroup 0 computes S (and P), warpgroup 1 dP, they swap them through
// shared memory, and each accumulates half of the D columns.  D = 64: each
// warpgroup owns 64 fixed rows (128 a block) with all D columns and computes
// both scores itself.  kStages: the streamed ring; kVec: 64 f32 LSE + 64 f32
// delta per stage (the dk / dv pass); kX: the swap buffer (32 f32 per thread
// per warpgroup).  The wrapper plans with kRows (flash_attention_bwd.wgmma_rows)
// and passes it in; a launch planned with other rows is refused.
template <int D>
struct Layout {
  static constexpr bool kSplit = D > 64;
  static constexpr int kRows = kSplit ? 64 : 128;   // fixed rows a block
  static constexpr int kCols = kSplit ? D / 2 : D;  // accumulator columns a warpgroup
  static constexpr int kNW = kCols / 2;             // accumulator floats a thread
  static constexpr int kStages = D >= 256 ? 2 : (D >= 128 ? 3 : 4);
  static constexpr int kBoxes = D / 64;
  static constexpr int kFixedBytes = kRows * D * 2;  // one of A1, A2
  static constexpr int kTileBytes = kTile * D * 2;   // one of B1, B2
  static constexpr int kA1 = 0;
  static constexpr int kA2 = kA1 + kFixedBytes;
  static constexpr int kB = kA2 + kFixedBytes;
  static constexpr int kVec = kB + kStages * 2 * kTileBytes;
  static constexpr int kX = kVec + kStages * 2 * kTile * 4;
  static constexpr int kXBytes = kSplit ? 2 * 32 * 128 * 4 : 0;
  static constexpr int kBar = kX + kXBytes;  // full[], empty[], fixed
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 B
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  void* out0;           // dq (dq pass) or dk (dk / dv pass), through o0s
  void* out1;           // dv, through o1s
  float* part0;         // (n_groups, B, NKV, S, D) f32 partials of dk / dv, or null
  float* part1;
  const float* lse2;    // (B, NQ, S_pad): lse * log2(e), 0 past S
  const float* delta;   // (B, NQ, S_pad): rowsum(dout * out), 0 past S
  Strides3 o0s, o1s;
  int B, NQ, NKV, G, S, S_pad, causal, window, hpg, n_groups;
  float scale, scale_log2;
};

// One block of one pass: block ``blk`` of the pass's ``n_blocks``.
template <typename T, int D, bool DKV>
__device__ __forceinline__ void bwd_block(const CUtensorMap* a1map, const CUtensorMap* a2map,
                                          const CUtensorMap* b1map, const CUtensorMap* b2map,
                                          const CUtensorMap* lsemap, const CUtensorMap* dlmap,
                                          const Params& p, int blk, int n_blocks) {
  using L = Layout<D>;
  constexpr int NST = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 B: align every tile to that.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same, generic
  const uint32_t bars = base + L::kBar;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (NST + st); };
  const uint32_t fixed_bar = bars + 8u * (2 * NST);
  const int S = p.S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The block's fixed rows, head(s) and batch.  The longest blocks first:
  // under a causal mask the last q tiles (dq) and the first key tiles
  // (dk / dv) have the most streamed tiles.
  int row0b, b, hA, h_first = 0, n_heads = 1, grp = 0;
  if constexpr (DKV) {
    const int per = p.n_groups * p.B * p.NKV;
    int rest = blk % per;
    row0b = (blk / per) * L::kRows;
    grp = rest % p.n_groups;
    rest /= p.n_groups;
    hA = rest % p.NKV;  // kv head
    b = rest / p.NKV;
    h_first = hA * p.G + grp * p.hpg;
    n_heads = min(p.G, (grp + 1) * p.hpg) - grp * p.hpg;
  } else {
    const int per = p.B * p.NQ;
    const int n_rt = n_blocks / per;
    const int rest = blk % per;
    row0b = (n_rt - 1 - blk / per) * L::kRows;
    hA = rest % p.NQ;  // q head
    b = rest / p.NQ;
  }
  const int row_last = min(row0b + L::kRows, S) - 1;

  // Streamed tiles the fixed rows see (whole tiles outside the band skipped).
  int t_begin = 0;
  int t_end = (S + kTile - 1) / kTile;
  if constexpr (DKV) {  // q tiles that see keys row0b .. row_last
    if (p.causal) t_begin = row0b / kTile;
    if (p.window > 0) t_end = min(t_end, (row_last + p.window - 1) / kTile + 1);
  } else {  // key tiles that q rows row0b .. row_last see
    if (p.causal) t_end = min(t_end, row_last / kTile + 1);
    if (p.window > 0) {
      const int lo = row0b - p.window + 1;
      if (lo > 0) t_begin = lo / kTile;
    }
  }
  const int n_t = max(0, t_end - t_begin);
  const int n_items = n_heads * n_t;  // dk / dv: heads outer, q tiles inner

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init(fixed_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(fixed_bar, 2 * L::kFixedBytes);
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j) {
        tma_load_4d(base + L::kA1 + j * (L::kRows * 128), a1map, fixed_bar, j * 64, row0b, hA, b);
        tma_load_4d(base + L::kA2 + j * (L::kRows * 128), a2map, fixed_bar, j * 64, row0b, hA, b);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_items; ++it) {
        const int hB = DKV ? h_first + it / n_t : hA / p.G;  // q head, or kv head
        const int r = (t_begin + it % n_t) * kTile;
        mbar_wait(empty(st), phase ^ 1u);  // the consumers released this stage
        mbar_expect_tx(full(st), 2 * L::kTileBytes + (DKV ? 2 * kTile * 4 : 0));
        const uint32_t b1 = base + L::kB + st * 2 * L::kTileBytes;
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
          tma_load_4d(b1 + j * (kTile * 128), b1map, full(st), j * 64, r, hB, b);
          tma_load_4d(b1 + L::kTileBytes + j * (kTile * 128), b2map, full(st), j * 64, r, hB, b);
        }
        if constexpr (DKV) {
          const uint32_t vec = base + L::kVec + st * (2 * kTile * 4);
          tma_load_3d(vec, lsemap, full(st), r, hB, b);
          tma_load_3d(vec + kTile * 4, dlmap, full(st), r, hB, b);
        }
        if (++st == NST) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  setmaxnreg_inc<kConsumerRegs>();
  using M = Mma<T>;
  const int wg = warp / 4;
  const int t = lane % 4;
  const int tid = threadIdx.x % 128;
  const int wrow0 = row0b + (L::kSplit ? 0 : 64 * wg);  // this warpgroup's first fixed row
  const int r0 = wrow0 + 16 * (warp % 4) + lane / 4;    // this thread's rows: r0, r0 + 8
  const uint32_t a_off = L::kSplit ? 0u : wg * (64u * 128u);
  // This warpgroup's accumulator columns start at box ``cbox``.
  const uint32_t cbox = L::kSplit ? wg * (L::kCols / 64) : 0;
  // In split mode warpgroup 0 computes S from A1, B1 and warpgroup 1 dP from A2, B2.
  const bool own_s = !L::kSplit || wg == 0;
  // The swap buffer: per warpgroup 8 float4 a thread, [c][thread].
  float4* const xmine = reinterpret_cast<float4*>(gbase + L::kX) + wg * (8 * 128) + tid;
  const float4* const xother = reinterpret_cast<const float4*>(gbase + L::kX) +
                               (1 - wg) * (8 * 128) + tid;

  // The dq pass's LSE and delta are per fixed row: two per thread.
  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};
  if constexpr (!DKV) {
    const long long lrow = ((long long)b * p.NQ + hA) * p.S_pad;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      lse_r[half] = p.lse2[lrow + r0 + 8 * half];
      dl_r[half] = p.delta[lrow + r0 + 8 * half];
    }
  }

  float acc0[L::kNW], acc1[DKV ? L::kNW : 1];
#pragma unroll
  for (int e = 0; e < L::kNW; ++e) acc0[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (DKV ? L::kNW : 1); ++e) acc1[e] = 0.f;

  mbar_wait(fixed_bar, 0);

  int st = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_items; ++it) {
    const int c0 = (t_begin + it % n_t) * kTile;  // the streamed tile's first row
    mbar_wait(full(st), phase);
    // q and key ranges of this warpgroup's (fixed rows, streamed tile) pair.
    const int q_lo = DKV ? c0 : wrow0, q_hi = q_lo + 63;
    const int k_lo = DKV ? wrow0 : c0, k_hi = k_lo + 63;
    // Whole tiles with no visible pair contribute exactly 0 (the same for
    // both warpgroups in split mode, so both skip the swap together).
    const bool active = q_lo < S && k_lo < S && !(p.causal && k_lo > q_hi) &&
                        !(p.window > 0 && q_lo - k_hi >= p.window);
    if (active) {
      const uint32_t b1 = base + L::kB + st * 2 * L::kTileBytes;
      const uint32_t b2 = b1 + L::kTileBytes;
      const float* const vl = reinterpret_cast<const float*>(gbase + L::kVec + st * (2 * kTile * 4));
      const float* const vd = vl + kTile;
      // Mask only on tiles that straddle the band or S.
      const bool edge = q_hi >= S || k_hi >= S || (p.causal && k_hi > q_lo) ||
                        (p.window > 0 && q_hi - k_lo >= p.window);

      // Scores: sc = A1.B1^T (S) or A2.B2^T (dP), 64 x 64 f32 over D in
      // steps of 16; without the split, dp = A2.B2^T as well.
      float sc[32], dp[L::kSplit ? 1 : 32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (L::kSplit ? 1 : 32); ++i) dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      {
        const uint32_t a = base + (own_s ? L::kA1 : L::kA2) + a_off;
        const uint32_t bb = own_s ? b1 : b2;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32u;  // 16 elements into the 128-byte row
          M::ss64(sc, desc_sw128(a + (kk / 4) * (L::kRows * 128) + off, 16, 1024),
                  desc_sw128(bb + (kk / 4) * (kTile * 128) + off, 16, 1024), kk > 0);
        }
      }
      if constexpr (!L::kSplit) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32u;
          M::ss64(dp, desc_sw128(base + L::kA2 + a_off + (kk / 4) * (L::kRows * 128) + off, 16, 1024),
                  desc_sw128(b2 + (kk / 4) * (kTile * 128) + off, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(s * scale - lse) in log2 units; masked pairs score the
      // sentinel, pairs past S get exactly 0.  Element i of a thread's 32 is
      // at row r0 + 8 ((i >> 1) & 1), column c0 + 8 (i / 4) + 2t + (i & 1):
      // the dk / dv pass reads the LSE of columns 8j + 2t, 8j + 2t + 1 as a
      // pair.
      if (own_s) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = DKV ? *reinterpret_cast<const float2*>(vl + 8 * j + 2 * t)
                                : make_float2(0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = 4 * j + u;
            const int row = r0 + 8 * ((i >> 1) & 1);
            const int col = c0 + 8 * j + 2 * t + (i & 1);
            const int q = DKV ? col : row, key = DKV ? row : col;
            const float l = DKV ? ((i & 1) ? l2.y : l2.x) : lse_r[(i >> 1) & 1];
            const float x = sc[i] * p.scale_log2;
            float pr;
            if (edge) {
              bool ok = true;
              if (p.causal) ok = ok && q >= key;
              if (p.window > 0) ok = ok && (q - key) < p.window;
              pr = (q >= S || key >= S) ? 0.f : exp2f((ok ? x : kNegInfL2) - l);
            } else {
              pr = exp2f(x - l);
            }
            sc[i] = pr;
          }
        }
      }
      if constexpr (L::kSplit) {  // swap P and dP between the warpgroups, 4 floats a store
        named_bar_sync(2, 256);   // the other one has read the previous tile's
#pragma unroll
        for (int c = 0; c < 8; ++c)
          xmine[c * 128] = make_float4(sc[4 * c], sc[4 * c + 1], sc[4 * c + 2], sc[4 * c + 3]);
        named_bar_sync(1, 256);
      }

      // dS = P (dP - delta) * scale; P and dS rounded to T as A fragments
      // (the accumulator order is the fragment order: fragment (kc, r)
      // packs elements 8kc + 2r and 8kc + 2r + 1).
      uint32_t pa[4][4], da[4][4];
      auto frags = [&](auto p_is_sc) {
        constexpr bool kPSc = decltype(p_is_sc)::value;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // elements 8kc + 4h .. + 3: one column pair
            const int j = 2 * kc + h;
            float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
            if constexpr (L::kSplit) o4 = xother[j * 128];
            const float2 d2 = DKV ? *reinterpret_cast<const float2*>(vd + 8 * j + 2 * t)
                                  : make_float2(0.f, 0.f);
            const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
            float pv[4], dsv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int i = 4 * j + u;
              float pi, dpi;
              if constexpr (!L::kSplit) {
                pi = sc[i];
                dpi = dp[i];
              } else if constexpr (kPSc) {
                pi = sc[i];
                dpi = ov[u];
              } else {
                pi = ov[u];
                dpi = sc[i];
              }
              const float dl = DKV ? ((u & 1) ? d2.y : d2.x) : dl_r[(u >> 1) & 1];
              pv[u] = pi;
              dsv[u] = pi * (dpi - dl) * p.scale;
            }
            pa[kc][2 * h] = M::pack(pv[0], pv[1]);
            pa[kc][2 * h + 1] = M::pack(pv[2], pv[3]);
            da[kc][2 * h] = M::pack(dsv[0], dsv[1]);
            da[kc][2 * h + 1] = M::pack(dsv[2], dsv[3]);
          }
        }
      };
      if (own_s) frags(std::true_type{});
      else frags(std::false_type{});

      // acc0 += dS.B1, acc1 += P.B2 over the tile's 64 rows in steps of 16;
      // B1 / B2 are the MN-major operands (the transpose bit), this
      // warpgroup's columns from box cbox (LBO = one box).
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t off = kc * (16 * 128) + cbox * (kTile * 128);
        const uint64_t d1 = desc_sw128(b1 + off, kTile * 128, 1024);
        if constexpr (L::kNW == 32) M::rs64(acc0, da[kc], d1);
        else M::rs128(acc0, da[kc], d1);
        if constexpr (DKV) {
          const uint64_t d2 = desc_sw128(b2 + off, kTile * 128, 1024);
          if constexpr (L::kNW == 32) M::rs64(acc1, pa[kc], d2);
          else M::rs128(acc1, pa[kc], d2);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if constexpr (DKV) {
        // dV += (P - P rounded).B2: P's rounding remainder, itself rounded to
        // T, so dV sees P to ~16 bits.  Rounding P once loses up to 2^-9 of
        // a p near 1, which an early key's few large terms do not average
        // away (dv off by ~0.02 at |dv| ~0.3 at recurrentgemma's shape).
        auto lo_frags = [&](auto p_is_sc) {
          constexpr bool kPSc = decltype(p_is_sc)::value;
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = 2 * kc + h;
              float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
              if constexpr (L::kSplit && !kPSc) o4 = xother[j * 128];
              const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
              float lv[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float pi = (!L::kSplit || kPSc) ? sc[4 * j + u] : ov[u];
                lv[u] = pi - M::round(pi);
              }
              pa[kc][2 * h] = M::pack(lv[0], lv[1]);
              pa[kc][2 * h + 1] = M::pack(lv[2], lv[3]);
            }
          }
        };
        if (own_s) lo_frags(std::true_type{});
        else lo_frags(std::false_type{});
        fence_regs(acc1);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const uint32_t off = kc * (16 * 128) + cbox * (kTile * 128);
          const uint64_t d2 = desc_sw128(b2 + off, kTile * 128, 1024);
          if constexpr (L::kNW == 32) M::rs64(acc1, pa[kc], d2);
          else M::rs128(acc1, pa[kc], d2);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    if (++st == NST) {
      st = 0;
      phase ^= 1u;
    }
  }

  // Rows < S: dq, or dk / dv (straight to T when one group covers the kv
  // head's G q heads, else this group's f32 partial).
  const int colbase = L::kSplit ? wg * L::kCols : 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < L::kNW / 4; ++jj) {
      const int e = 4 * jj + 2 * half;
      const int col = colbase + 8 * jj + 2 * t;
      if constexpr (!DKV) {
        T* o = static_cast<T*>(p.out0) + b * p.o0s.b + hA * p.o0s.h + (long long)row * p.o0s.s + col;
        *reinterpret_cast<uint32_t*>(o) = M::pack(acc0[e], acc0[e + 1]);
      } else if (p.part0 == nullptr) {
        T* o0 = static_cast<T*>(p.out0) + b * p.o0s.b + hA * p.o0s.h + (long long)row * p.o0s.s + col;
        T* o1 = static_cast<T*>(p.out1) + b * p.o1s.b + hA * p.o1s.h + (long long)row * p.o1s.s + col;
        *reinterpret_cast<uint32_t*>(o0) = M::pack(acc0[e], acc0[e + 1]);
        *reinterpret_cast<uint32_t*>(o1) = M::pack(acc1[e], acc1[e + 1]);
      } else {
        const long long off =
            ((((long long)grp * p.B + b) * p.NKV + hA) * S + row) * D + col;
        *reinterpret_cast<float2*>(p.part0 + off) = make_float2(acc0[e], acc0[e + 1]);
        *reinterpret_cast<float2*>(p.part1 + off) = make_float2(acc1[e], acc1[e + 1]);
      }
    }
  }
}

// Both passes in one grid, so that the dq blocks fill the SMs the dk / dv
// pass's causal tail leaves idle: blocks [0, n_dkv) are dk / dv blocks (the
// longest first), the rest dq blocks (the longest first).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap kfix, const __grid_constant__ CUtensorMap vfix,
                       const __grid_constant__ CUtensorMap qstr, const __grid_constant__ CUtensorMap dostr,
                       const __grid_constant__ CUtensorMap qfix, const __grid_constant__ CUtensorMap dofix,
                       const __grid_constant__ CUtensorMap kstr, const __grid_constant__ CUtensorMap vstr,
                       const __grid_constant__ CUtensorMap lsemap,
                       const __grid_constant__ CUtensorMap dlmap, const __grid_constant__ Params pk,
                       const __grid_constant__ Params pq, int n_dkv) {
  const int blk = blockIdx.x;
  if (blk < n_dkv)
    bwd_block<T, D, true>(&kfix, &vfix, &qstr, &dostr, &lsemap, &dlmap, pk, blk, n_dkv);
  else
    bwd_block<T, D, false>(&qfix, &dofix, &kstr, &vstr, &lsemap, &dlmap, pq, blk - n_dkv,
                           gridDim.x - n_dkv);
}

// lse2 = lse * log2(e) and delta = rowsum(dout * out) (f32, one warp a row,
// 8 elements a lane from 16-byte loads, a fixed shuffle order) into (B, NQ,
// S_pad) scratch, zero past S.  D = 64, 128, 256: D / 8 lanes load.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ lse2, float* __restrict__ delta, Strides3 os, Strides3 dos, int NQ,
    int S, int S_pad, int D) {
  const int s = blockIdx.x * 8 + threadIdx.x / 32;
  const int h = blockIdx.y, b = blockIdx.z, lane = threadIdx.x % 32;
  float acc = 0.f;
  if (s < S && lane * 8 < D) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + b * os.b + h * os.h +
                                                    (long long)s * os.s + lane * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h +
                                                    (long long)s * dos.s + lane * 8);
    const T* ov = reinterpret_cast<const T*>(&o);
    const T* dv = reinterpret_cast<const T*>(&d);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc += to_f32(dv[c]) * to_f32(ov[c]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long row = (long long)b * NQ + h;
    delta[row * S_pad + s] = s < S ? acc : 0.f;
    lse2[row * S_pad + s] = s < S ? lse[row * S + s] * kLog2e : 0.f;
  }
}

// dk[b, kvh] = the sum over groups g = 0, 1, ... (in that order, f32) of
// part0[g, b, kvh], cast to T; dv likewise from part1.  Four columns a
// thread (D is a multiple of 64; dk / dv rows 8-byte aligned).
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_group_merge_kernel(
    const float* __restrict__ part0, const float* __restrict__ part1, T* __restrict__ dk,
    T* __restrict__ dv, Strides3 dks, Strides3 dvs, int n_groups, int NKV, int S, int D,
    long long total) {
  using M = hopper::Mma<T>;
  const long long quads = total / 4;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < quads; i += gridDim.x * 256ll) {
    const long long e = 4 * i;
    const int d = (int)(e % D);
    const int s = (int)((e / D) % S);
    const int kvh = (int)((e / ((long long)S * D)) % NKV);
    const int b = (int)(e / ((long long)NKV * S * D));
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < n_groups; ++g) {
      const float4 a = reinterpret_cast<const float4*>(part0 + g * total)[i];
      const float4 c = reinterpret_cast<const float4*>(part1 + g * total)[i];
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    *reinterpret_cast<uint2*>(dk + b * dks.b + kvh * dks.h + (long long)s * dks.s + d) =
        make_uint2(M::pack(sk.x, sk.y), M::pack(sk.z, sk.w));
    *reinterpret_cast<uint2*>(dv + b * dvs.b + kvh * dvs.h + (long long)s * dvs.s + d) =
        make_uint2(M::pack(sv.x, sv.y), M::pack(sv.z, sv.w));
  }
}

struct Operands {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float *lse2, *delta, *part0, *part1;
  void *dq, *dk, *dv;
  Strides3 qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, NQ, NKV, S, S_pad, rows, hpg, causal, window;
  float scale;
};

// A 3-D map (S_pad, NQ, B) over the f32 LSE / delta scratch, boxes of 64.
bool make_vec_map(CUtensorMap* map, const float* ptr, int S_pad, int NQ, int B) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)S_pad, (cuuint64_t)NQ, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)S_pad * 4, (cuuint64_t)S_pad * NQ * 4};
  cuuint32_t box[3] = {(cuuint32_t)kTile, 1, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t launch(const Operands& o, cudaStream_t stream) {
  using L = Layout<D>;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int G = o.NQ / o.NKV;
  const int n_groups = (G + o.hpg - 1) / o.hpg;
  if (o.rows != L::kRows || o.hpg < 1 || o.S_pad % 128 != 0 || o.S_pad < o.S ||
      (n_groups > 1 && o.part0 == nullptr))
    return cudaErrorInvalidValue;
  // Fixed operands in boxes of kRows rows, streamed ones in boxes of 64.
  CUtensorMap qf, dof, kf, vf, qs, dos, ks, vs, lsem, dlm;
  auto map = [&](CUtensorMap* m, const void* ptr, int N, const Strides3& st, int rows) {
    return make_map_4d(m, ptr, dt, D, o.S, N, o.B, st.s, st.h, st.b, rows);
  };
  if (!map(&qf, o.q, o.NQ, o.qs, L::kRows) || !map(&dof, o.dout, o.NQ, o.dos, L::kRows) ||
      !map(&kf, o.k, o.NKV, o.ks, L::kRows) || !map(&vf, o.v, o.NKV, o.vs, L::kRows) ||
      !map(&qs, o.q, o.NQ, o.qs, kTile) || !map(&dos, o.dout, o.NQ, o.dos, kTile) ||
      !map(&ks, o.k, o.NKV, o.ks, kTile) || !map(&vs, o.v, o.NKV, o.vs, kTile) ||
      !make_vec_map(&lsem, o.lse2, o.S_pad, o.NQ, o.B) ||
      !make_vec_map(&dlm, o.delta, o.S_pad, o.NQ, o.B))
    return cudaErrorInvalidValue;

  flash_bwd_prep_kernel<T><<<dim3(o.S_pad / 8, o.NQ, o.B), 256, 0, stream>>>(
      static_cast<const T*>(o.out), static_cast<const T*>(o.dout), o.lse, o.lse2, o.delta, o.os,
      o.dos, o.NQ, o.S, o.S_pad, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Params p{};
  p.lse2 = o.lse2;
  p.delta = o.delta;
  p.B = o.B; p.NQ = o.NQ; p.NKV = o.NKV; p.G = G; p.S = o.S; p.S_pad = o.S_pad;
  p.causal = o.causal; p.window = o.window; p.hpg = o.hpg; p.n_groups = n_groups;
  p.scale = o.scale;
  p.scale_log2 = o.scale * kLog2e;
  constexpr int smem = L::kAlloc;
  const int n_rt = (o.S + L::kRows - 1) / L::kRows;

  // dk / dv: a block per (key tile, head group, kv head, batch); dq: a block
  // per (q tile, q head, batch); one grid.
  Params pk = p;
  pk.out0 = o.dk; pk.out1 = o.dv; pk.o0s = o.dks; pk.o1s = o.dvs;
  pk.part0 = n_groups > 1 ? o.part0 : nullptr;
  pk.part1 = n_groups > 1 ? o.part1 : nullptr;
  Params pq = p;
  pq.out0 = o.dq; pq.o0s = o.dqs;
  const int n_dkv = n_rt * n_groups * o.B * o.NKV;
  auto kernel = flash_bwd_wgmma_kernel<T, D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_dkv + n_rt * o.B * o.NQ, kThreads, smem, stream>>>(
      kf, vf, qs, dos, qf, dof, ks, vs, lsem, dlm, pk, pq, n_dkv);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_groups == 1) return err;
  const long long total = (long long)o.B * o.NKV * o.S * D;
  const int blocks = (int)std::min<long long>((total / 4 + 255) / 256, 132 * 16);
  flash_bwd_group_merge_kernel<T><<<blocks, 256, 0, stream>>>(
      o.part0, o.part1, static_cast<T*>(o.dk), static_cast<T*>(o.dv), o.dks, o.dvs, n_groups,
      o.NKV, o.S, D, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Operands& o, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(o, stream);
    case 128: return launch<T, 128>(o, stream);
    case 256: return launch<T, 256>(o, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcb

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

// The tensor-core route (bf16 / f16, D = 64 / 128 / 256): q, out, dout, dq
// (B, NQ, S, D) and k, v, dk, dv (B, NKV, S, D) through element strides,
// q, k, v, out, dout 16-byte aligned with strides in 16-byte units (TMA and
// 16-byte loads), dk / dv rows 8-byte aligned; lse (B, NQ, S) f32
// contiguous.  Scratch from the caller: lse2 and
// delta (B, NQ, S_pad) f32 with S_pad a multiple of 128 >= S, and, when
// heads_per_group < NQ / NKV, part_dk / part_dv (n_groups, B, NKV, S, D) f32.
// ``rows``: the fixed rows a block the caller planned with; anything but
// Layout<D>::kRows is refused (cudaErrorInvalidValue).
// Three launches on ``stream``: the LSE / delta pass, one grid of dk / dv
// and dq blocks, the group merge (more than one group only).  Returns the
// first CUDA error.
extern "C" int flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* lse2, void* delta, void* part_dk, void* part_dv, void* dq, void* dk,
    void* dv, int dtype, int B, int NQ, int NKV, int S, int D, int S_pad, int rows,
    int heads_per_group,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || NQ <= 0 || NKV <= 0 || S <= 0 || NQ % NKV != 0) return (int)cudaErrorInvalidValue;
  tcb::Operands o{};
  o.q = q; o.k = k; o.v = v; o.out = out; o.dout = dout;
  o.lse = static_cast<const float*>(lse);
  o.lse2 = static_cast<float*>(lse2);
  o.delta = static_cast<float*>(delta);
  o.part0 = static_cast<float*>(part_dk);
  o.part1 = static_cast<float*>(part_dv);
  o.dq = dq; o.dk = dk; o.dv = dv;
  o.qs = Strides3{q_sb, q_sh, q_ss};
  o.ks = Strides3{k_sb, k_sh, k_ss};
  o.vs = Strides3{v_sb, v_sh, v_ss};
  o.os = Strides3{o_sb, o_sh, o_ss};
  o.dos = Strides3{do_sb, do_sh, do_ss};
  o.dqs = Strides3{dq_sb, dq_sh, dq_ss};
  o.dks = Strides3{dk_sb, dk_sh, dk_ss};
  o.dvs = Strides3{dv_sb, dv_sh, dv_ss};
  o.B = B; o.NQ = NQ; o.NKV = NKV; o.S = S; o.S_pad = S_pad; o.rows = rows;
  o.hpg = heads_per_group;
  o.causal = causal; o.window = window; o.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return (int)tcb::dispatch_d<__nv_bfloat16>(D, o, st);
    case kF16: return (int)tcb::dispatch_d<__half>(D, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
