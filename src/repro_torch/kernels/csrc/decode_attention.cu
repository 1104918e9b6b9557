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
// Both entry points run one kernel (split::decode_split_kernel, the ring
// and the paged pool as two instantiations).  The first designs gave each
// (kv head, row, group of 8 query heads) one block: 32 blocks at tier-l's
// ring batch of 4, 8 at recurrentgemma's (B 4, NKV 1, G 10), 64 at the
// continuous tier's 8 slots, on 132 SMs, and each block walked all of its
// row's keys alone.  This design:
// * splits each row's keys into n_split chunks, one block each; the Python
//   planner (decode_attention.split_plan) picks n_split, and how many of a
//   kv head's query heads a block holds (16, 8 or 4), from B, NKV, G, the
//   key range S and the SM count, so the grid reaches one wave: 160 blocks
//   at tier-l's ring (all 5 heads per block), 132 at recurrentgemma's
//   (heads in blocks of 4: with all 10 heads the chunks shrink to 4 keys
//   and the f32 partials outweigh the cache), 192 at the continuous tier's
//   pool (8 rows x 8 kv heads x 3 chunks);
// * the ring's chunks cut its slot range (valid slots sit anywhere once the
//   ring wraps) at the planned chunk length.  The pool's chunks cut the
//   row's live span [max(0, pos - window + 1), pos + 1), which each block
//   works out on the device from pos (the host never reads it: no sync,
//   and the launch can be captured in a CUDA graph) into n_split equal
//   parts; a chunk past the span reads nothing and contributes nothing.
//   Pages are append-only, so dense index i holds absolute position i and
//   every key of the span is valid;
// * a block scores its chunk kStep (256) keys at a time and carries its
//   softmax state (m, l, acc) from step to step, so a chunk has no length
//   limit (the ring's 65536-slot cap is gone; plans up to 65536 slots have
//   chunks of at most 256 keys, one step, as before);
// * within a step, lanes read 16-byte vectors (8 bf16 features), so a warp
//   covers 32 / LPK keys per load, with LPK the lanes per key: D / 8 in
//   bf16 rounded up to a power of two (D = 80 / 96 give 10 / 12 vectors on
//   16 lanes; the spare lanes hold zero features); every key's scores for
//   all the block's heads are computed first, the per-head sums reduced
//   across the lanes of a key by a reduce-scatter (about one shuffle per
//   head instead of log2 of the lane count), then one max, one exp pass and
//   one sum per head, then P.V with 16-byte loads of v;
// * the pool's page ids for a step are staged in shared memory first: one
//   table read per page touched, and a chunk may start or end mid-page;
// * each chunk writes f32 partials (m, l, acc) to scratch; the last block
//   of each (row, kv head, head group) to finish, found by a ticket counter
//   (atomicAdd after __threadfence, in the same launch), merges them in
//   chunk order, so the output is bitwise the same from run to run, and
//   resets its ticket to 0 for the next launch on the stream (one buffer
//   serves both entry points).
// A chunk with a valid key reads k and v of its valid keys only (the
// others weigh exp(-1e30 - m) = 0 exactly) and contributes exactly 0 to
// the merge when it has none, once any chunk has one (exp(-1e30 - M) = 0).
// A chunk with no valid key writes m = -1e30, l = its key count and acc =
// the sum of its v, so a row with no valid key at all (pos = -1, or only
// empty slots; in the pool, an empty span takes every entry, all masked)
// merges to the uniform mean of v, as the Pallas kernels and the plain
// versions give.
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

// Shared launch arguments of both entry points.
struct Args {
  const void *q, *k, *v;
  const int *index, *pos;  // slot_pos or page tables
  void* out;
  int B, NKV, G, S, page;  // S: slots, or NB * page entries of a row's table
  Strides3 qs, ks, vs;
  long long index_sb;
  Strides3 os;
  int window;
  float scale;
  cudaStream_t stream;
  // The split plan (query heads per block, chunks; chunk is the ring's
  // only) and scratch.
  int heads, n_split, chunk;
  float *part_acc, *part_ml;
  int* tickets;
};

// ===========================================================================
// Split across the keys: one block per (key chunk, kv head, batch row,
// group of up to 16 query heads), then a fixed-order combine by the last
// block of each (row, kv head, group) to finish (a ticket in the same launch).
// ===========================================================================
namespace split {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;       // query heads per block at most (grid.z covers larger G)
constexpr int kStep = 256;      // keys a block scores at a time; longer chunks take steps
constexpr int kMaxSplit = 256;  // chunks per row; the Python planner keeps to it
static_assert(kMaxSplit <= kStep, "the merge keeps one factor per chunk in a step's buffer");

constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

// 16-byte loads: VEC elements each; a key's D features are NVEC loads,
// spread over LPK lanes (a power of two; lanes past NVEC hold zeros) with
// NV loads each (F features per lane); a warp step covers KPW keys.
template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static_assert(D % VEC == 0, "a key's features must be whole 16-byte loads");
  static constexpr int NVEC = D / VEC;
  static constexpr int LPK = NVEC < 32 ? pow2_at_least(NVEC) : 32;
  static constexpr int NV = (NVEC + LPK - 1) / LPK;
  static constexpr int KPW = 32 / LPK;
  static constexpr int F = NV * VEC;
  // The feature of load n, element e of this lane (lane % LPK).
  static __device__ __forceinline__ int feat(int lk, int n, int e) {
    return (n * LPK + lk) * VEC + e;
  }
  // Whether load n of this lane holds features (always, when NVEC fills the lanes).
  static __device__ __forceinline__ bool has(int lk, int n) {
    return NVEC % LPK == 0 || n * LPK + lk < NVEC;
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

// This lane's F features of a key (zeros where the lane holds none, or
// when ``load`` is false).
template <typename T, int D>
__device__ __forceinline__ void load_key(const T* row, int lk, bool load,
                                         float (&f)[Geo<T, D>::F]) {
  using Gm = Geo<T, D>;
#pragma unroll
  for (int nv = 0; nv < Gm::NV; ++nv) {
    if (load && Gm::has(lk, nv)) load16(row + Gm::feat(lk, nv, 0), &f[nv * Gm::VEC]);
    else
#pragma unroll
      for (int e = 0; e < Gm::VEC; ++e) f[nv * Gm::VEC + e] = 0.f;
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

// PAGED = false: k / v are (B, NKV, S, D) ring caches, ``index`` the (B, S)
// slot positions, chunk c the slots [c * chunk, (c + 1) * chunk).
// PAGED = true: k / v are (P, NKV, page, D) pools, ``index`` the (B, S /
// page) page tables, chunk c the c-th of n_split equal parts of the row's
// live span (``chunk`` unused).
template <typename T, int D, int GP, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ index,
                    const int* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ tickets, int NKV, int G, int S, int page, int n_gz,
                    int chunk, Strides3 qs, Strides3 ks, Strides3 vs, long long index_sb,
                    Strides3 os, int window, float scale) {
  using Gm = Geo<T, D>;
  constexpr int F = Gm::F, LPK = Gm::LPK, KPW = Gm::KPW;
  __shared__ float s_s[GP][kStep];  // scores, then weights; the combine's factors
  __shared__ float acc_s[GP][D];
  __shared__ float m_s[GP], l_s[GP], corr_s[GP];
  __shared__ unsigned char valid_s[kStep];
  __shared__ int pid_s[PAGED ? kStep + 1 : 1];  // a step's page ids
  __shared__ int last_s;

  const int c = blockIdx.x;
  const int n_split = gridDim.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_gz;
  const int gz = blockIdx.z % n_gz;
  const int g0 = gz * GP;
  const int ng = min(GP, G - g0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lk = lane % LPK;   // this lane's slice of a key
  const int slot = lane / LPK;  // which of the warp's KPW keys
  const int p = pos[b];
  const int* ib = index + b * index_sb;

  // ---- this block's keys [c0, c0 + n) of the row; n_used chunks hold keys ----
  int c0, n, n_used;
  bool masked = false;  // the pool's empty span: every entry, all masked
  if constexpr (PAGED) {
    int lo = window > 0 ? max(0, p - window + 1) : 0;
    int hi = min(p + 1, S);
    if (lo >= hi) {
      lo = 0;
      hi = S;
      masked = true;
    }
    const int len = hi - lo;
    const int cs = (len + n_split - 1) / n_split;
    c0 = lo + c * cs;
    n = min(cs, hi - c0);  // <= 0 past the span
    n_used = (len + cs - 1) / cs;
  } else {
    c0 = c * chunk;
    n = min(chunk, S - c0);  // >= 1: the planner leaves no chunk empty
    n_used = n_split;
  }
  const long long row0 = ((long long)b * NKV + h) * n_split;  // (b, h, chunk 0)

  if (n > 0) {
    // The key at index kk (absolute in the row) of this step: its k / v
    // rows, and whether it is valid.
    const T* kb = k + h * ks.h;
    const T* vb = v + h * vs.h;
    if constexpr (!PAGED) {
      kb += b * ks.b;
      vb += b * vs.b;
    }
    int pg0 = 0;  // the step's first page (PAGED)
    auto koff = [&](int kk, const Strides3& st) -> long long {
      if constexpr (PAGED)
        return (long long)pid_s[kk / page - pg0] * st.b + (long long)(kk % page) * st.s;
      else
        return (long long)kk * st.s;
    };
    auto key_valid = [&](int kk) -> bool {
      if constexpr (PAGED) return !masked;
      else return slot_valid(ib[kk], p, window);
    };

    bool seen = false;  // a valid key in an earlier step (block-uniform)
    for (int s0 = 0; s0 < n; s0 += kStep) {
      const int ns = min(kStep, n - s0);
      const int k0 = c0 + s0;
      if constexpr (PAGED) {  // one table read per page the step touches
        pg0 = k0 / page;
        const int npg = (k0 + ns - 1) / page - pg0 + 1;
        for (int j = tid; j < npg; j += kThreads) pid_s[j] = ib[pg0 + j];
        __syncthreads();
      }

      // ---- scores of every key of the step for every query head ----
      float qr[GP][F];
      {
        const T* qb = q + b * qs.b + h * qs.h + g0 * qs.s;
#pragma unroll
        for (int g = 0; g < GP; ++g) load_key<T, D>(qb + g * qs.s, lk, g < ng, qr[g]);
      }
      bool any_valid = false;
      for (int i0 = warp * KPW; i0 < ns; i0 += kWarps * KPW) {
        const int i = i0 + slot;
        const bool in = i < ns;
        const bool valid = in && key_valid(k0 + i);
        any_valid = any_valid || valid;
        float kf[F];
        load_key<T, D>(valid ? kb + koff(k0 + i, ks) : kb, lk, valid, kf);
        float dot[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float a = 0.f;
#pragma unroll
          for (int f = 0; f < F; ++f) a += qr[g][f] * kf[f];
          dot[g] = a;
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
      // From here on a masked key weighs exp(-1e30 - m) = 0 exactly.
      const bool skip_masked = __syncthreads_or(any_valid) || seen;
      seen = skip_masked;

      // ---- one max, one exp pass and one sum per head; the state carried ----
      for (int g = warp; g < ng; g += kWarps) {
        float mx = -INFINITY;
        for (int i = lane; i < ns; i += 32) mx = fmaxf(mx, s_s[g][i]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = s0 == 0 ? mx : fmaxf(m_s[g], mx);
        float sum = 0.f;
        for (int i = lane; i < ns; i += 32) {
          const float e = expf(s_s[g][i] - m_new);  // exactly 0 for a masked key once m is valid
          s_s[g][i] = e;
          sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          if (s0 == 0) {
            l_s[g] = sum;
          } else {
            const float corr = expf(m_s[g] - m_new);
            corr_s[g] = corr;
            l_s[g] = l_s[g] * corr + sum;
          }
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // ---- P . V: once a valid key is seen, v of valid keys only (the
      // others weigh exactly 0); before that every v ----
      float acc[GP][F];
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int f = 0; f < F; ++f) acc[g][f] = 0.f;
      for (int i0 = warp * KPW; i0 < ns; i0 += kWarps * KPW) {
        const int i = i0 + slot;
        if (i >= ns || (skip_masked && !valid_s[i])) continue;
        float vf[F];
        load_key<T, D>(vb + koff(k0 + i, vs), lk, true, vf);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float pg = g < ng ? s_s[g][i] : 0.f;
#pragma unroll
          for (int f = 0; f < F; ++f) acc[g][f] += pg * vf[f];
        }
      }
      // The warp's KPW key slots, then the warps in a fixed order, into the
      // block's acc (rescaled by exp(m_old - m_new) after the first step).
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
            for (int nv = 0; nv < Gm::NV; ++nv) {
              if (!Gm::has(lk, nv)) continue;
#pragma unroll
              for (int e = 0; e < Gm::VEC; ++e) {
                const int d = Gm::feat(lk, nv, e);
                const float prev = w > 0 ? acc_s[g][d] : s0 > 0 ? acc_s[g][d] * corr_s[g] : 0.f;
                acc_s[g][d] = prev + acc[g][nv * Gm::VEC + e];
              }
            }
          }
        }
        __syncthreads();  // also: s_s, valid_s and pid_s are free for the next step
      }
    }

    // ---- this chunk's partials (m, l, acc), f32 ----
    for (int idx = tid; idx < ng * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      part_acc[((row0 + c) * G + g0 + g) * D + d] = acc_s[g][d];
    }
    if (tid < ng) {
      part_ml[((row0 + c) * G + g0 + tid) * 2] = m_s[tid];
      part_ml[((row0 + c) * G + g0 + tid) * 2 + 1] = l_s[tid];
    }
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + ((long long)b * NKV + h) * n_gz + gz;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;

  // ---- the last block of the group merges the chunks in order 0..n_used-1 ----
  __threadfence();
  if (tid < ng) {
    const int g = tid;
    float M = -INFINITY;
    for (int cc = 0; cc < n_used; ++cc)
      M = fmaxf(M, __ldcg(&part_ml[((row0 + cc) * G + g0 + g) * 2]));
    float L = 0.f;
    for (int cc = 0; cc < n_used; ++cc) {
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
    for (int cc = 0; cc < n_used; ++cc) {
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

// Calls f(std::integral_constant<int, GP>{}) for a block's query heads.
template <class F>
cudaError_t with_heads(int heads, F&& f) {
  switch (heads) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D, bool PAGED>
cudaError_t launch(const Args& a) {
  if (a.n_split <= 0 || a.n_split > kMaxSplit) return cudaErrorInvalidValue;
  if (PAGED ? a.page <= 0 || a.S % a.page != 0
            : (a.chunk <= 0 || (long long)a.n_split * a.chunk < a.S ||
               (long long)(a.n_split - 1) * a.chunk >= a.S))
    return cudaErrorInvalidValue;
  const int n_gz = (a.G + a.heads - 1) / a.heads;
  dim3 grid(a.n_split, a.NKV, a.B * n_gz);
  return with_heads(a.heads, [&](auto gp) {
    decode_split_kernel<T, D, decltype(gp)::value, PAGED><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.index, a.pos, static_cast<T*>(a.out), a.part_acc, a.part_ml, a.tickets, a.NKV, a.G,
        a.S, a.page, n_gz, a.chunk, a.qs, a.ks, a.vs, a.index_sb, a.os, a.window, a.scale);
    return cudaGetLastError();
  });
}

// How many blocks of the paged kernel one SM holds at once.
template <typename T, int D>
cudaError_t paged_blocks_per_sm(int heads, int* n) {
  return with_heads(heads, [&](auto gp) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_split_kernel<T, D, decltype(gp)::value, true>, kThreads, 0);
  });
}

}  // namespace split

// Calls f.template operator()<T, D>() for a dtype code and head dim.
template <class F>
cudaError_t with_type_and_dim(int dtype, int D, F&& f) {
  auto dims = [&](auto t) -> cudaError_t {
    using T = decltype(t);
    switch (D) {
      case 16: return f.template operator()<T, 16>();
      case 32: return f.template operator()<T, 32>();
      case 64: return f.template operator()<T, 64>();
      case 80: return f.template operator()<T, 80>();
      case 96: return f.template operator()<T, 96>();
      case 128: return f.template operator()<T, 128>();
      case 256: return f.template operator()<T, 256>();
      default: return cudaErrorInvalidValue;
    }
  };
  switch (dtype) {
    case kF32: return dims(float{});
    case kBF16: return dims(__nv_bfloat16{});
    case kF16: return dims(__half{});
    default: return cudaErrorInvalidValue;
  }
}

struct Launch {
  const Args& a;
  bool paged;
  template <typename T, int D>
  cudaError_t operator()() const {
    return paged ? split::launch<T, D, true>(a) : split::launch<T, D, false>(a);
  }
};

struct PagedOccupancy {
  int heads;
  int* n;
  template <typename T, int D>
  cudaError_t operator()() const {
    return split::paged_blocks_per_sm<T, D>(heads, n);
  }
};

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
// n_split <= 256).  Scratch: part_acc (B, NKV, n_split, G, D) and part_ml
// (B, NKV, n_split, G, 2) f32, uninitialised; tickets (B, NKV, ceil(G /
// heads)) int32, zero before the launch and zero again after it (the last
// block of each group resets its ticket), so one buffer serves every
// launch on a stream.  Returns cudaGetLastError().
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
               B, NKV, G, S, 0,
               Strides3{q_sb, q_sh, q_sg}, Strides3{k_sb, k_sh, k_ss}, Strides3{v_sb, v_sh, v_ss},
               sp_sb, Strides3{o_sb, o_sh, o_sg}, window, scale,
               static_cast<cudaStream_t>(stream), heads, n_split, chunk,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<int*>(tickets)};
  return (int)repro_torch::with_type_and_dim(dtype, D, repro_torch::Launch{a, false});
}

// q and out as above; k/v pools: (P, NKV, page, D) addressed as (page id,
// kv head, offset) strides; page_tables: (B, NB) int32 page ids in [0, P)
// with row stride tb_sb and contiguous entries; pos: (B,) int32 contiguous.
// Feature dims contiguous; q, the pools and out 16-byte aligned with
// strides of whole 16-byte units.  A block takes ``heads`` query heads of
// one kv head and one of n_split equal parts of its row's live span, which
// it works out from pos on the device.  Scratch and tickets as above.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* k_pool, const void* v_pool, const void* page_tables,
    const void* pos, void* out, void* part_acc, void* part_ml, void* tickets, int heads,
    int n_split, int dtype, int B, int NKV, int G, int NB, int page, int D,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sp, long long k_sh, long long k_si,
    long long v_sp, long long v_sh, long long v_si,
    long long tb_sb,
    long long o_sb, long long o_sh, long long o_sg,
    int window, float scale, void* stream) {
  if (B <= 0 || NKV <= 0 || G <= 0 || NB <= 0 || page <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(page_tables),
               static_cast<const int*>(pos), out, B, NKV, G, NB * page, page,
               Strides3{q_sb, q_sh, q_sg}, Strides3{k_sp, k_sh, k_si}, Strides3{v_sp, v_sh, v_si},
               tb_sb, Strides3{o_sb, o_sh, o_sg}, window, scale,
               static_cast<cudaStream_t>(stream), heads, n_split, 0,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               static_cast<int*>(tickets)};
  return (int)repro_torch::with_type_and_dim(dtype, D, repro_torch::Launch{a, true});
}

// Blocks of the paged kernel (dtype, D, ``heads`` query heads a block) that
// one SM of the current device holds at once, into *blocks: what the
// planner fills one resident wave with.  Returns the CUDA error code.
extern "C" int decode_attention_paged_blocks_per_sm(int dtype, int D, int heads, int* blocks) {
  return (int)repro_torch::with_type_and_dim(dtype, D, repro_torch::PagedOccupancy{heads, blocks});
}
