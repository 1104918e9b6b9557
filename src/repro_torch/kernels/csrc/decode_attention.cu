// Decode attention for Hopper (sm_90a): one new query token per row against
// a KV cache, f32 online softmax.  Two entry points share one design:
//
// * decode_attention_fwd: a dense (ring-buffer) cache per row.  Replaces
//   the Pallas TPU kernel repro/kernels/decode_attention.py
//   (decode_attention_fwd, pallas_call at :88, _kernel at :26).
// * decode_attention_paged_fwd: a shared page pool read through per-row
//   page tables (the continuous-batching tier).  Replaces the Pallas TPU
//   kernel repro/kernels/decode_attention.py (decode_attention_paged_fwd,
//   pallas_call at :207, _paged_kernel at :111).
//
// Bound on the H100: memory.  Each step reads every live cache entry once
// (2 * D bytes per key per kv head in bf16) and does 4 * G * D FLOPs on
// it, far below the ~295 FLOP/byte the card needs to be compute-bound.
// What the design does about it: one block per (kv head, batch row, group
// of up to 8 query heads) holds all G query rows of that kv head in
// registers, so the cache is streamed once for the whole GQA group; each
// warp reads its share of the keys with 32 lanes on consecutive features
// (coalesced), keeps its own online-softmax state, and the eight warps'
// states merge through shared memory in a fixed order (deterministic).
// With B * NKV = 64 blocks at the served shapes the grid does not fill 132
// SMs; splitting S across blocks is later work.
//
// Ring cache: keys whose slot fails the mask are not read once the warp
// has seen a valid key: their weight exp(-1e30 - m) is exactly 0 in f32.
// Paged pool: pages are append-only, so dense index i holds absolute
// position i and the mask is i <= pos (plus the window).  The key range is
// cut to the valid span [max(0, pos - window + 1), pos + 1) before the
// loop (masked keys outside it have weight exactly 0 once a valid key
// exists, and on this path key pos always is one); warps take whole pages
// in turn, so each warp reads a page's id from the table once per page.
// Keys past pos (the unfilled tail of a row's last page, trash-padded
// table entries) are never read.  A row with no valid key at all (pos < 0)
// reads every entry and softmaxes the sentinels to the mean of v, as the
// Pallas kernel does.
//
// Semantics match the Pallas kernels: masked scores use the finite
// sentinel -1e30 (a fully masked row is the mean of v), P.V stays in f32
// and l is clamped at 1e-30.  Caches and pools are addressed through
// element strides, so the model's (B, S, NKV, HD) ring cache and its
// (P, page, NKV, HD) page pool are read in place.
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
decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ slot_pos,
                  const int* __restrict__ pos, T* __restrict__ out, int G, int S,
                  Strides3 qs, Strides3 ks, Strides3 vs, long long sp_sb,
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

  const int p = pos[b];
  const int* spb = slot_pos + b * sp_sb;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const int per_warp = (S + kWarps - 1) / kWarps;
  const int s_begin = warp * per_warp;
  const int s_end = min(S, s_begin + per_warp);
  bool seen_valid = false;

  for (int s0 = s_begin; s0 < s_end; s0 += U) {
    bool ok[U], use[U];
    float kd[U][DPL], vd[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u;
      bool valid = false;
      if (s < s_end) {
        const int sp = spb[s];
        valid = sp >= 0 && sp <= p;
        if (window > 0) valid = valid && sp > p - window;
      }
      ok[u] = valid;
      // A masked key is exact to skip once a valid key set m finite.
      use[u] = s < s_end && (valid || !seen_valid);
      load_kv<T, D>(kb + (long long)s * ks.s, vb + (long long)s * vs.s, valid, use[u], lane,
                    kd[u], vd[u]);
    }
    online_update<D>(qr, kd, vd, ok, use, ng, scale, m, l, acc, seen_valid);
  }
  merge_store<T, D>(m, l, acc, ng, out + b * os.b + h * os.h + g0 * os.s, os.s);
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
};

template <typename T, int D>
cudaError_t launch(const Args& a, bool paged) {
  dim3 grid(a.NKV, a.B, (a.G + kMaxG - 1) / kMaxG);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  if (paged) {
    decode_paged_fwd_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, a.index, a.pos, out, a.G, a.NB, a.page, a.qs, a.ks, a.vs, a.index_sb, a.os,
        a.window, a.scale);
  } else {
    decode_fwd_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
        q, k, v, a.index, a.pos, out, a.G, a.S, a.qs, a.ks, a.vs, a.index_sb, a.os, a.window,
        a.scale);
  }
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
// contiguous slots; pos: (B,) int32 contiguous.  Feature dims contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* slot_pos, const void* pos,
    void* out, int dtype, int B, int NKV, int G, int S, int D,
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
               static_cast<cudaStream_t>(stream)};
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
               static_cast<cudaStream_t>(stream)};
  return repro_torch::dispatch(dtype, D, a, true);
}
