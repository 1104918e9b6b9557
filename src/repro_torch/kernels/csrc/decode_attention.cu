// Ring-cache decode attention for Hopper (sm_90a): one new query token per
// row against a dense (ring-buffer) KV cache, f32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_fwd, pallas_call at :88, _kernel at :26).
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
// Keys whose slot fails the mask are not read once the warp has seen a
// valid key: their weight exp(-1e30 - m) is exactly 0 in f32.  With
// B * NKV = 64 blocks at the served shapes the grid does not fill 132 SMs;
// splitting S across blocks is later work.
//
// Semantics match the Pallas kernel: the mask is 0 <= slot_pos <= pos plus
// the window, masked scores use the finite sentinel -1e30 (a fully masked
// row is the mean of v), P.V stays in f32 and l is clamped at 1e-30.  The
// caches are addressed through (batch, head, seq) element strides, so the
// model's (B, S, NKV, HD) ring cache is read in place.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;  // query heads per block (grid.z covers larger G)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ slot_pos,
                  const int* __restrict__ pos, T* __restrict__ out, int G, int S,
                  Strides3 qs, Strides3 ks, Strides3 vs, long long sp_sb,
                  Strides3 os, int window, float scale) {
  constexpr int DPL = (D + 31) / 32;  // features per lane
  constexpr int U = D >= 256 ? 2 : 4;  // keys in flight per warp
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];
  __shared__ float acc_s[kMaxG][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g0 = blockIdx.z * kMaxG;
  const int ng = min(kMaxG, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      qr[g][j] = (g < ng && d < D)
                     ? to_f32(q[b * qs.b + h * qs.h + (g0 + g) * qs.s + d])
                     : 0.f;
    }

  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

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
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        const bool in = d < D;
        kd[u][j] = (valid && in) ? to_f32(kb[(long long)s * ks.s + d]) : 0.f;
        vd[u][j] = (use[u] && in) ? to_f32(vb[(long long)s * vs.s + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
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

  // Merge the warps' softmax states in a fixed order.
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
        for (int j = 0; j < DPL; ++j) {
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
    out[b * os.b + h * os.h + (g0 + g) * os.s + d] = from_f32<T>(acc_s[g][d] / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* slot_pos,
                   const int* pos, void* out, int B, int NKV, int G, int S,
                   Strides3 qs, Strides3 ks, Strides3 vs, long long sp_sb, Strides3 os,
                   int window, float scale, cudaStream_t stream) {
  dim3 grid(NKV, B, (G + kMaxG - 1) / kMaxG);
  decode_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      slot_pos, pos, static_cast<T*>(out), G, S, qs, ks, vs, sp_sb, os, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* slot_pos, const int* pos, void* out, int B, int NKV,
                       int G, int S, Strides3 qs, Strides3 ks, Strides3 vs,
                       long long sp_sb, Strides3 os, int window, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, slot_pos, pos, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, slot_pos, pos, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, slot_pos, pos, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, slot_pos, pos, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, slot_pos, pos, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

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
  using namespace repro_torch;
  if (B <= 0 || NKV <= 0 || G <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Strides3 qs{q_sb, q_sh, q_sg}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_sg};
  const int* sp = static_cast<const int*>(slot_pos);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = dispatch_d<float>(D, q, k, v, sp, ps, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, st);
      break;
    case kBF16:
      err = dispatch_d<__nv_bfloat16>(D, q, k, v, sp, ps, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, st);
      break;
    case kF16:
      err = dispatch_d<__half>(D, q, k, v, sp, ps, out, B, NKV, G, S, qs, ks, vs, sp_sb, os, window, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
