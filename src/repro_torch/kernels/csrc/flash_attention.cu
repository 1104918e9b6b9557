// Flash-attention forward for Hopper (sm_90a): online-softmax attention over
// K/V tiles in shared memory, f32 accumulation, GQA by kv head = q head / G.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, pallas_call at :119, _kernel at :30).
//
// Bound on the H100: at the prefill shapes of the serving path (S = 128,
// D = 128, bf16) the work is ~4*S*D FLOPs per (row, key) pair against
// 2*D bytes per row read once, so the tensor-core roofline bounds it; this
// first kernel does its products in f32 on the CUDA cores (no wgmma), so it
// runs below that roofline by design.  What the design does about it: each
// K/V tile is loaded once per block into shared memory and reused by all 64
// query rows of the tile, scores and P.V are register-blocked (each thread
// owns BK/4 score columns and D/4 output columns of one row, one shared
// load per FMA), and causal / window tiles outside the band are skipped.
//
// Semantics match the Pallas kernel exactly: the finite sentinel -1e30 for
// masked scores, l clamped at 1e-30, the output in q's dtype and an
// optional f32 log-sum-exp.  Unlike the Pallas kernel, S need not be a
// multiple of the tile: keys past S get weight exactly 0 and rows past S
// are not stored.  Operands are addressed through (batch, head, seq)
// element strides, so the model's (B, S, N, HD) activations are read in
// place.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;                       // query rows per block
constexpr int kThreads = 256;                 // 4 threads per query row
constexpr int kLanesPerRow = kThreads / kBQ;  // 4 (adjacent lanes of a warp)

template <int D, int BK>
constexpr int smem_floats() {
  return kBQ * (D + 1) + BK * (D + 1) + BK * D + kBQ * (BK + 1);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int NQ, int G, int S, Strides3 qs,
                 Strides3 ks, Strides3 vs, Strides3 os, int causal, int window,
                 float scale) {
  constexpr int CPT = BK / kLanesPerRow;  // score columns per thread
  constexpr int DPT = D / kLanesPerRow;   // output features per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][D + 1]  (+1: no bank conflicts)
  float* k_s = q_s + kBQ * (D + 1);  // [BK][D + 1]
  float* v_s = k_s + BK * (D + 1);   // [BK][D]
  float* p_s = v_s + BK * D;         // [kBQ][BK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const int qpos = q0 + row;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, s = q0 + r;
    q_s[r * (D + 1) + d] = s < S ? to_f32(qb[(long long)s * qs.s + d]) : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  // Key tiles this query tile needs (whole tiles outside the band skipped).
  int kt_begin = 0;
  int kt_end = (S + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, S) - 1) / BK + 1);
  if (window > 0) {
    const int lo = q0 - window + 1;  // the smallest key the first row sees
    if (lo > 0) kt_begin = lo / BK;
  }

  const float* qr = q_s + row * (D + 1);
  float* pr = p_s + row * (BK + 1);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D, d = i % D, s = k0 + c;
      const bool in = s < S;
      k_s[c * (D + 1) + d] = in ? to_f32(kb[(long long)s * ks.s + d]) : 0.f;
      v_s[c * D + d] = in ? to_f32(vb[(long long)s * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        sc[j] += qd * k_s[(lane + kLanesPerRow * j) * (D + 1) + d];
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kpos = k0 + lane + kLanesPerRow * j;
      bool ok = true;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      float s = ok ? sc[j] * scale : kNegInf;
      if (kpos >= S) s = -INFINITY;  // past the sequence: weight exactly 0
      sc[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    // Every processed tile holds a key < S, so m_new >= -1e30 is finite.
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      pr[lane + kLanesPerRow * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= corr;
    __syncwarp();  // the row's four writers share this warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
      const float* vr = v_s + c * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += p * vr[lane + kLanesPerRow * j];
    }
  }

  if (qpos < S) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = out + b * os.b + h * os.h + (long long)qpos * os.s;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[lane + kLanesPerRow * j] = from_f32<T>(acc[j] / lc);
    if (lse != nullptr && lane == 0) lse[((long long)b * NQ + h) * S + qpos] = m + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int NQ, int NKV, int S, Strides3 qs, Strides3 ks,
                   Strides3 vs, Strides3 os, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;
  constexpr int smem = smem_floats<D, BK>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, NQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, NQ, NQ / NKV, S, qs, ks, vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int NQ, int NKV, int S, Strides3 qs,
                       Strides3 ks, Strides3 vs, Strides3 os, int causal, int window,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

using repro_torch::Strides3;

// q: (B, NQ, S, D), k/v: (B, NKV, S, D), out: (B, NQ, S, D) addressed through
// the given element strides (feature dim contiguous); lse: (B, NQ, S) f32,
// contiguous, or null.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int dtype,
    int B, int NQ, int NKV, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || NQ <= 0 || NKV <= 0 || S <= 0 || NQ % NKV != 0)
    return (int)cudaErrorInvalidValue;
  const Strides3 qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = dispatch_d<float>(D, q, k, v, out, lse_f, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, st);
      break;
    case kBF16:
      err = dispatch_d<__nv_bfloat16>(D, q, k, v, out, lse_f, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, st);
      break;
    case kF16:
      err = dispatch_d<__half>(D, q, k, v, out, lse_f, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
