// Decode attention for Hopper (sm_90a): one new query token per row against
// a KV cache, f32 softmax.  Two entry points:
//
// * decode_attention_fwd: a dense (ring-buffer) cache per row.  Replaces
//   the Pallas TPU kernel repro/kernels/decode_attention.py
//   (decode_attention_fwd, pallas_call at :88, _kernel at :26).
// * decode_attention_paged_fwd: a shared page pool read through per-row
//   page tables (the continuous-batching tier).  Replaces the Pallas TPU
//   kernel repro/kernels/decode_attention.py (decode_attention_paged_fwd,
//   pallas_call at :207, _paged_kernel at :111).
//
// Bound on the H100: memory, and at the served shapes latency.  Each step
// reads every live cache entry once (2 * D bytes per key per kv head in
// bf16) and does 4 * G * D FLOPs on it, far below the ~295 FLOP/byte the
// card needs to be compute-bound; at tier-l's step (q (4, 8, 5, 128), 129
// live keys of 152 slots) that is 1.1 MB, 0.0003 ms at 3.35 TB/s, so what
// costs is how few SMs a grid of (kv head, row) blocks keeps busy and how
// long each block's dependent chain is.
//
// Ring cache (decode_fwd_split_kernel).  The first design gave each (kv
// head, row, group of 8 query heads) one block: 32 blocks at tier-l's batch
// of 4, 8 at recurrentgemma's (B 4, NKV 1, G 10), on 132 SMs, and each warp
// walked S / 8 keys with a 5-step shuffle reduction and two expf per key
// and query head.  This design:
// * splits the ring's slot range (valid slots sit anywhere once the ring
//   wraps) into n_split chunks, one block each; the Python planner
//   (decode_attention.split_plan) picks n_split, and how many of a kv
//   head's query heads a block holds (16, 8 or 4), from B, NKV, G, S and
//   the SM count, so the grid reaches one wave: 160 blocks at tier-l (all
//   5 heads per block), 132 at recurrentgemma (heads in blocks of 4: with
//   all 10 heads the chunks shrink to 4 keys and the f32 partials outweigh
//   the cache);
// * within a chunk, lanes read 16-byte vectors (8 bf16 features), so a
//   warp covers 32 / (D / 8) keys per load; every key's scores for all the
//   block's heads are computed first, the per-head sums reduced across the
//   lanes of a key by a reduce-scatter (about one shuffle per head instead
//   of log2 of the lane count), then one max, one exp pass and one sum per
//   head, then P.V with 16-byte loads of v;
// * each chunk writes f32 partials (m, l, acc) to scratch; the last block
//   of each (row, kv head, head group) to finish, found by a ticket counter
//   (atomicAdd after __threadfence, in the same launch), merges them in
//   chunk order 0..n_split-1, so the output is bitwise the same from run to
//   run, and resets its ticket to 0 for the next launch on the stream.
// A chunk with a valid key reads k and v of its valid keys only (the
// others weigh exp(-1e30 - m) = 0 exactly) and contributes exactly 0 to
// the merge when it has none, once any chunk has one (exp(-1e30 - M) = 0).
// A chunk with no valid key writes m = -1e30, l = its key count and acc =
// the sum of its v, so a row with no valid key at all (pos = -1, or only
// empty slots) merges to the uniform mean of v, as the Pallas kernel and
// the plain version give.
//
// Paged pool (decode_paged_fwd_kernel, the first design, not split yet):
// one block per (kv head, row, group of up to 8 query heads) holds all G
// query rows of that kv head in registers, so the pool is streamed once
// for the whole GQA group; each warp reads its share of the keys with 32
// lanes on consecutive features and keeps its own online-softmax state,
// and the eight warps' states merge through shared memory in a fixed
// order.  Pages are append-only, so dense index i holds absolute position
// i and the mask is i <= pos (plus the window).  The key range is cut to
// the valid span [max(0, pos - window + 1), pos + 1) before the loop;
// warps take whole pages in turn, so each warp reads a page's id from the
// table once per page.  Keys past pos are never read.  A row with no valid
// key at all (pos < 0) reads every entry and softmaxes the sentinels to
// the mean of v, as the Pallas kernel does.  The ring kernel's split plan
// and merge are written to be reused here.
//
// Semantics match the Pallas kernels: masked scores use the finite
// sentinel -1e30 (a fully masked row is the mean of v), P.V stays in f32
// and l is clamped at 1e-30.  Caches and pools are addressed through
// element strides, so the model's (B, S, NKV, HD) ring cache and its
// (P, page, NKV, HD) page pool are read in place.
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;  // query heads per block (grid.z covers larger G)

template <int D>
struct Dims {
  static constexpr int DPL = (D + 31) / 32;  // features per lane
  static constexpr int U = D >= 256 ? 2 : 4;  // keys in flight per warp
};

// This block's up-to-kMaxG query rows (qb points at row g0), one feature
// slice per lane, and the online-softmax state initialised.
template <typename T, int D>
__device__ __forceinline__ void load_q(const T* qb, long long q_sg, int ng, int lane,
                                       float (&qr)[kMaxG][Dims<D>::DPL],
                                       float (&m)[kMaxG], float (&l)[kMaxG],
                                       float (&acc)[kMaxG][Dims<D>::DPL]) {
  constexpr int DPL = Dims<D>::DPL;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = (g < ng && d < D) ? to_f32(qb[g * q_sg + d]) : 0.f;
      acc[g][j] = 0.f;
    }
  }
}

// Loads key/value u of a U-wide step: k only for a valid key, v for every
// key the warp uses (a masked key is used only until a valid one is seen).
template <typename T, int D>
__device__ __forceinline__ void load_kv(const T* kp, const T* vp, bool valid, bool use,
                                        int lane, float (&kd)[Dims<D>::DPL],
                                        float (&vd)[Dims<D>::DPL]) {
#pragma unroll
  for (int j = 0; j < Dims<D>::DPL; ++j) {
    const int d = lane + 32 * j;
    const bool in = d < D;
    kd[j] = (valid && in) ? to_f32(kp[d]) : 0.f;
    vd[j] = (use && in) ? to_f32(vp[d]) : 0.f;
  }
}

// One online-softmax update of the warp's state with up to U keys.
template <int D>
__device__ __forceinline__ void online_update(
    float (&qr)[kMaxG][Dims<D>::DPL], float (&kd)[Dims<D>::U][Dims<D>::DPL],
    float (&vd)[Dims<D>::U][Dims<D>::DPL], bool (&ok)[Dims<D>::U],
    bool (&use)[Dims<D>::U], int ng, float scale, float (&m)[kMaxG],
    float (&l)[kMaxG], float (&acc)[kMaxG][Dims<D>::DPL], bool& seen_valid) {
  constexpr int DPL = Dims<D>::DPL;
#pragma unroll
  for (int u = 0; u < Dims<D>::U; ++u) {
    if (!use[u]) continue;  // warp-uniform
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= ng) break;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) dot += qr[g][j] * kd[u][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float sc = ok[u] ? dot * scale : kNegInf;
      const float m_new = fmaxf(m[g], sc);
      const float corr = expf(m[g] - m_new);
      const float pw = expf(sc - m_new);
      l[g] = l[g] * corr + pw;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] = acc[g][j] * corr + pw * vd[u][j];
      m[g] = m_new;
    }
    seen_valid = seen_valid || ok[u];
  }
}

// Merges the warps' softmax states in a fixed order and writes the block's
// output rows (ob points at row g0).
template <typename T, int D>
__device__ __forceinline__ void merge_store(float (&m)[kMaxG], float (&l)[kMaxG],
                                            float (&acc)[kMaxG][Dims<D>::DPL], int ng,
                                            T* ob, long long o_sg) {
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];
  __shared__ float acc_s[kMaxG][D];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  float m_all[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    float mx = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    m_all[g] = mx;
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= ng) break;
        const float f = expf(m[g] - m_all[g]);
#pragma unroll
        for (int j = 0; j < Dims<D>::DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc_s[g][d] = (w == 0 ? 0.f : acc_s[g][d]) + acc[g][j] * f;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ng * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w) L += l_s[w][g] * expf(m_s[w][g] - m_all[g]);
    ob[g * o_sg + d] = from_f32<T>(acc_s[g][d] / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_paged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool, const int* __restrict__ tables,
                        const int* __restrict__ pos, T* __restrict__ out, int G, int NB,
                        int page, Strides3 qs, Strides3 ks, Strides3 vs, long long tb_sb,
                        Strides3 os, int window, float scale) {
  constexpr int DPL = Dims<D>::DPL;
  constexpr int U = Dims<D>::U;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = blockIdx.z * kMaxG;
  const int ng = min(kMaxG, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[kMaxG][DPL], m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
  load_q<T, D>(q + b * qs.b + h * qs.h + g0 * qs.s, qs.s, ng, lane, qr, m, l, acc);

  // The valid span of dense indices; empty (pos < 0, or a window past the
  // pages) falls back to every entry, all masked: the mean of v.
  const int S = NB * page;
  const int p = pos[b];
  int lo = window > 0 ? max(0, p - window + 1) : 0;
  int hi = min(p + 1, S);
  if (lo >= hi) {
    lo = 0;
    hi = S;
  }
  const int* tbl = tables + b * tb_sb;
  bool seen_valid = false;

  for (int pg = lo / page + warp; pg * page < hi; pg += kWarps) {
    const long long pid = tbl[pg];  // one table read per page
    const T* kpg = kpool + pid * ks.b + h * ks.h;
    const T* vpg = vpool + pid * vs.b + h * vs.h;
    const int base = pg * page;
    const int i_end = min(hi, base + page) - base;
    for (int i0 = max(lo, base) - base; i0 < i_end; i0 += U) {
      bool ok[U], use[U];
      float kd[U][DPL], vd[U][DPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        const int idx = base + i;
        bool valid = i < i_end && idx <= p;
        if (window > 0) valid = valid && idx > p - window;
        ok[u] = valid;
        use[u] = i < i_end && (valid || !seen_valid);
        load_kv<T, D>(kpg + (long long)i * ks.s, vpg + (long long)i * vs.s, valid, use[u],
                      lane, kd[u], vd[u]);
      }
      online_update<D>(qr, kd, vd, ok, use, ng, scale, m, l, acc, seen_valid);
    }
  }
  merge_store<T, D>(m, l, acc, ng, out + b * os.b + h * os.h + g0 * os.s, os.s);
}

// Shared launch arguments of both entry points.
struct Args {
  const void *q, *k, *v;
  const int *index, *pos;  // slot_pos or page tables
  void* out;
  int B, NKV, G, S, NB, page;
  Strides3 qs, ks, vs;
  long long index_sb;
  Strides3 os;
  int window;
  float scale;
  cudaStream_t stream;
  // The ring kernel's split plan (query heads per block, chunks) and scratch.
  int heads, n_split, chunk;
  float *part_acc, *part_ml;
  int* tickets;
};

// ===========================================================================
// Ring cache, split across S: one block per (key chunk, kv head, batch row,
// group of up to 16 query heads), then a fixed-order combine by the last
// block of each (row, kv head, group) to finish (a ticket in the same launch).
// ===========================================================================
namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;       // query heads per block at most (grid.z covers larger G)
constexpr int kMaxChunk = 256;  // keys per block; the Python planner keeps to it
constexpr int kMaxSplit = 256;  // chunks per row; the Python planner keeps to it

// 16-byte loads: VEC elements each; LPK lanes cover one key's D features
// with NV loads each (F features per lane); a warp step covers KPW keys.
template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int LPK = D / VEC < 32 ? D / VEC : 32;
  static constexpr int NV = D / (VEC * LPK);
  static constexpr int KPW = 32 / LPK;
  static constexpr int F = NV * VEC;
  // The feature of load n, element e of this lane (lane % LPK).
  static __device__ __forceinline__ int feat(int lk, int n, int e) {
    return (n * LPK + lk) * VEC + e;
  }
};

// Eight bf16 / f16 or four f32 values of one 16-byte load, widened to f32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T pair[2];
      memcpy(pair, &w[i], 4);
      out[2 * i] = to_f32(pair[0]);
      out[2 * i + 1] = to_f32(pair[1]);
    }
  }
}

// Sums each of the GP values over the LPK lanes of a key with about GP
// shuffles in all instead of GP * log2(LPK): each level keeps half of the
// values and swaps the other half with the partner lane.  Afterwards this
// lane holds the totals of heads g_off + j, j < max(1, GP / LPK).
template <int GP, int LPK>
__device__ __forceinline__ int reduce_scatter(float (&v)[GP], int lane) {
  int g_off = 0;
  int n = GP;
#pragma unroll
  for (int o = LPK / 2; o >= 1; o >>= 1) {
    if (n > 1) {
      const int half = n / 2;
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int j = 0; j < GP / 2; ++j) {
        if (j < half) {
          const float send = upper ? v[j] : v[j + half];
          const float keep = upper ? v[j + half] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (upper) g_off += half;
      n = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return g_off;
}

__device__ __forceinline__ bool slot_valid(int sp, int p, int window) {
  return sp >= 0 && sp <= p && (window <= 0 || sp > p - window);
}

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
decode_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ slot_pos,
                        const int* __restrict__ pos, T* __restrict__ out,
                        float* __restrict__ part_acc, float* __restrict__ part_ml,
                        int* __restrict__ tickets, int NKV, int G, int S, int n_gz, int chunk,
                        Strides3 qs, Strides3 ks, Strides3 vs, long long sp_sb, Strides3 os,
                        int window, float scale) {
  using Gm = Geo<T, D>;
  constexpr int F = Gm::F, LPK = Gm::LPK, KPW = Gm::KPW, VEC = Gm::VEC;
  __shared__ float s_s[GP][kMaxChunk];  // scores, then weights; the combine's factors
  __shared__ float acc_s[GP][D];
  __shared__ float m_s[GP], l_s[GP];
  __shared__ unsigned char valid_s[kMaxChunk];
  __shared__ int last_s;

  const int c = blockIdx.x;
  const int n_split = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_gz;
  const int gz = blockIdx.z % n_gz;
  const int g0 = gz * GP;
  const int ng = min(GP, G - g0);
  const int c0 = c * chunk;
  const int n = min(chunk, S - c0);  // keys of this chunk (>= 1: no chunk is empty)
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lk = lane % LPK;   // this lane's slice of a key
  const int slot = lane / LPK;  // which of the warp's KPW keys
  const int p = pos[b];
  const int* spb = slot_pos + b * sp_sb;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  // ---- scores of every key of the chunk for every query head ----
  float qr[GP][F];
  {
    const T* qb = q + b * qs.b + h * qs.h + g0 * qs.s;
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int nv = 0; nv < Gm::NV; ++nv) {
        if (g < ng) load16(qb + g * qs.s + Gm::feat(lk, nv, 0), &qr[g][nv * VEC]);
        else
#pragma unroll
          for (int e = 0; e < VEC; ++e) qr[g][nv * VEC + e] = 0.f;
      }
  }
  bool any_valid = false;
  for (int i0 = warp * KPW; i0 < n; i0 += kWarps * KPW) {
    const int i = i0 + slot;
    const bool in = i < n;
    const bool valid = in && slot_valid(spb[c0 + i], p, window);
    any_valid = any_valid || valid;
    float kf[F];
#pragma unroll
    for (int nv = 0; nv < Gm::NV; ++nv) {
      if (valid) load16(kb + (long long)(c0 + i) * ks.s + Gm::feat(lk, nv, 0), &kf[nv * VEC]);
      else
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[nv * VEC + e] = 0.f;
    }
    float dot[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc += qr[g][f] * kf[f];
      dot[g] = acc;
    }
    const int g_off = reduce_scatter<GP, LPK>(dot, lane);
    if (in) {
#pragma unroll
      for (int j = 0; j < (GP / LPK > 1 ? GP / LPK : 1); ++j) {
        const int g = g_off + j;
        if (g < ng) s_s[g][i] = valid ? dot[j] * scale : kNegInf;
      }
      if (lk == 0) valid_s[i] = valid;
    }
  }
  any_valid = __syncthreads_or(any_valid);

  // ---- one max, one exp pass and one sum per head ----
  for (int g = warp; g < ng; g += kWarps) {
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, s_s[g][i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(s_s[g][i] - mx);  // exactly 0 for a masked key once mx is valid
      s_s[g][i] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // ---- P . V: a chunk with a valid key reads v of its valid keys only
  // (the others weigh exactly 0); a chunk without one reads every v ----
  float acc[GP][F];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[g][f] = 0.f;
  for (int i0 = warp * KPW; i0 < n; i0 += kWarps * KPW) {
    const int i = i0 + slot;
    if (i >= n || (any_valid && !valid_s[i])) continue;
    float vf[F];
#pragma unroll
    for (int nv = 0; nv < Gm::NV; ++nv)
      load16(vb + (long long)(c0 + i) * vs.s + Gm::feat(lk, nv, 0), &vf[nv * VEC]);
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float pg = g < ng ? s_s[g][i] : 0.f;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[g][f] += pg * vf[f];
    }
  }
  // The warp's KPW key slots, then the warps in a fixed order.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[g][f] += __shfl_xor_sync(0xffffffffu, acc[g][f], o);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && slot == 0) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        if (g >= ng) break;
#pragma unroll
        for (int nv = 0; nv < Gm::NV; ++nv)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int d = Gm::feat(lk, nv, e);
            acc_s[g][d] = (w == 0 ? 0.f : acc_s[g][d]) + acc[g][nv * VEC + e];
          }
      }
    }
    __syncthreads();
  }

  // ---- this chunk's partials (m, l, acc), f32 ----
  const long long row0 = ((long long)b * NKV + h) * n_split;  // (b, h, chunk 0)
  for (int idx = tid; idx < ng * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    part_acc[((row0 + c) * G + g0 + g) * D + d] = acc_s[g][d];
  }
  if (tid < ng) {
    part_ml[((row0 + c) * G + g0 + tid) * 2] = m_s[tid];
    part_ml[((row0 + c) * G + g0 + tid) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + ((long long)b * NKV + h) * n_gz + gz;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;

  // ---- the last block of the group merges the chunks in order 0..n_split-1 ----
  __threadfence();
  if (tid < ng) {
    const int g = tid;
    float M = -INFINITY;
    for (int cc = 0; cc < n_split; ++cc) M = fmaxf(M, __ldcg(&part_ml[((row0 + cc) * G + g0 + g) * 2]));
    float L = 0.f;
    for (int cc = 0; cc < n_split; ++cc) {
      const float* ml = &part_ml[((row0 + cc) * G + g0 + g) * 2];
      const float f = expf(__ldcg(ml) - M);  // 0 for a chunk of masked keys only, once M is valid
      s_s[g][cc] = f;
      L += __ldcg(ml + 1) * f;
    }
    l_s[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // Four features per thread and step (16-byte loads), chunks in order.
  T* ob = out + b * os.b + h * os.h + g0 * os.s;
  for (int idx = tid; idx < ng * (D / 4); idx += kThreads) {
    const int g = idx / (D / 4), d = 4 * (idx % (D / 4));
    const float4* src =
        reinterpret_cast<const float4*>(&part_acc[(row0 * G + g0 + g) * D + d]);
    const long long step = (long long)G * D / 4;  // one chunk further
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int cc = 0; cc < n_split; ++cc) {
      const float4 x = __ldcg(src + cc * step);
      const float f = s_s[g][cc];
      o.x += x.x * f;
      o.y += x.y * f;
      o.z += x.z * f;
      o.w += x.w * f;
    }
    const float inv = 1.f / l_s[g];
    T* orow = ob + g * os.s + d;
    orow[0] = from_f32<T>(o.x * inv);
    orow[1] = from_f32<T>(o.y * inv);
    orow[2] = from_f32<T>(o.z * inv);
    orow[3] = from_f32<T>(o.w * inv);
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch on this stream
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  if (a.chunk <= 0 || a.chunk > kMaxChunk || a.n_split <= 0 || a.n_split > kMaxSplit ||
      (long long)a.n_split * a.chunk < a.S || (long long)(a.n_split - 1) * a.chunk >= a.S)
    return cudaErrorInvalidValue;
  const int n_gz = (a.G + a.heads - 1) / a.heads;
  dim3 grid(a.n_split, a.NKV, a.B * n_gz);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
#define REPRO_SPLIT_ARGS                                                                       \
  q, k, v, a.index, a.pos, out, a.part_acc, a.part_ml, a.tickets, a.NKV, a.G, a.S, n_gz,      \
      a.chunk, a.qs, a.ks, a.vs, a.index_sb, a.os, a.window, a.scale
  switch (a.heads) {
    case 4:
      decode_fwd_split_kernel<T, D, 4><<<grid, kThreads, 0, a.stream>>>(REPRO_SPLIT_ARGS);
      break;
    case 8:
      decode_fwd_split_kernel<T, D, 8><<<grid, kThreads, 0, a.stream>>>(REPRO_SPLIT_ARGS);
      break;
    case 16:
      decode_fwd_split_kernel<T, D, 16><<<grid, kThreads, 0, a.stream>>>(REPRO_SPLIT_ARGS);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SPLIT_ARGS
  return cudaGetLastError();
}

}  // namespace split

template <typename T, int D>
cudaError_t launch(const Args& a, bool paged) {
  if (!paged) return split::launch<T, D>(a);
  dim3 grid(a.NKV, a.B, (a.G + kMaxG - 1) / kMaxG);
  decode_paged_fwd_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.index, a.pos, static_cast<T*>(a.out), a.G, a.NB, a.page, a.qs, a.ks, a.vs, a.index_sb,
      a.os, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, bool paged) {
  switch (D) {
    case 16: return launch<T, 16>(a, paged);
    case 32: return launch<T, 32>(a, paged);
    case 64: return launch<T, 64>(a, paged);
    case 128: return launch<T, 128>(a, paged);
    case 256: return launch<T, 256>(a, paged);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int D, const Args& a, bool paged) {
  cudaError_t err;
  switch (dtype) {
    case kF32: err = dispatch_d<float>(D, a, paged); break;
    case kBF16: err = dispatch_d<__nv_bfloat16>(D, a, paged); break;
    case kF16: err = dispatch_d<__half>(D, a, paged); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace
}  // namespace repro_torch

using repro_torch::Args;
using repro_torch::Strides3;

// q: (B, NKV, G, D) and out: (B, NKV, G, D) addressed as (batch, kv head,
// group row) strides; k/v caches: (B, NKV, S, D) addressed as (batch, kv
// head, slot) strides; slot_pos: (B, S) int32 with row stride sp_sb and
// contiguous slots; pos: (B,) int32 contiguous.  Feature dims contiguous;
// q, k, v and out 16-byte aligned with strides of whole 16-byte units.  A
// block takes ``heads`` (4, 8 or 16) query heads of one kv head and one of
// n_split chunks of ``chunk`` slots (the last may be shorter, none empty;
// chunk <= 256, n_split <= 256).  Scratch: part_acc (B, NKV, n_split, G,
// D) and part_ml (B, NKV, n_split, G, 2) f32, uninitialised; tickets (B,
// NKV, ceil(G / heads)) int32, zero before the launch and zero
// again after it (the last block of each group resets its ticket), so one
// buffer serves every launch on a stream.  Returns cudaGetLastError().
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* slot_pos, const void* pos,
    void* out, void* part_acc, void* part_ml, void* tickets, int heads, int n_split, int chunk,
    int dtype, int B, int NKV, int G, int S, int D,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long sp_sb,
    long long o_sb, long long o_sh, long long o_sg,
    int window, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || G <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(slot_pos), static_cast<const int*>(pos), out,
               B, NKV, G, S, 0, 0,
               Strides3{q_sb, q_sh, q_sg}, Strides3{k_sb, k_sh, k_ss}, Strides3{v_sb, v_sh, v_ss},
               sp_sb, Strides3{o_sb, o_sh, o_sg}, window, scale,
               static_cast<cudaStream_t>(stream), heads, n_split, chunk,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<int*>(tickets)};
  return repro_torch::dispatch(dtype, D, a, false);
}

// q and out as above; k/v pools: (P, NKV, page, D) addressed as (page id,
// kv head, offset) strides; page_tables: (B, NB) int32 page ids in [0, P)
// with row stride tb_sb and contiguous entries; pos: (B,) int32 contiguous.
// Feature dims contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* page_tables,
    const void* pos, void* out, int dtype, int B, int NKV, int G, int NB, int page, int D,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sp, long long k_sh, long long k_si,
    long long v_sp, long long v_sh, long long v_si,
    long long tb_sb,
    long long o_sb, long long o_sh, long long o_sg,
    int window, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || G <= 0 || NB <= 0 || page <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(page_tables),
               static_cast<const int*>(pos), out, B, NKV, G, NB * page, NB, page,
               Strides3{q_sb, q_sh, q_sg}, Strides3{k_sp, k_sh, k_si}, Strides3{v_sp, v_sh, v_si},
               tb_sb, Strides3{o_sb, o_sh, o_sg}, window, scale,
               static_cast<cudaStream_t>(stream), 0, 0, 0, nullptr, nullptr, nullptr};
  return repro_torch::dispatch(dtype, D, a, true);
}
