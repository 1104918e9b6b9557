// Shared helpers for the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Finite masked-score sentinel, as in the Pallas kernels: a fully masked
// row softmaxes to the uniform mean of v instead of NaN.
constexpr float kNegInf = -1e30f;

// dtype codes passed by the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Element strides of one (batch, head, sequence) indexed operand whose
// last (feature) dimension is contiguous.
struct Strides3 {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// ---- attention masks: the causal / window band and a prefix-LM prefix ----
// The JAX model's rule (repro/models/attention.py ``_block_mask``): query
// qpos sees key kpos when ``(causal & window) | (kpos < prefix_len[b])``,
// so every query of batch row b sees the row's first prefix_len[b] keys.

// prefix_len[b] clamped to [0, S]; 0 without a prefix (a null pointer).
__device__ __forceinline__ int prefix_of(const int* prefix, int b, int S) {
  return prefix == nullptr ? 0 : min(max(prefix[b], 0), S);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window, int pl) {
  bool ok = true;
  if (causal) ok = ok && qpos >= kpos;
  if (window > 0) ok = ok && (qpos - kpos) < window;
  return ok || kpos < pl;
}

// [begin, end) of the key tiles of ``bk`` keys that query rows r_lo .. r_hi
// (r_hi < S) see: under causal up to the diagonal, and at least to the end
// of the prefix; with a window from the first row's window start, unless a
// prefix reaches back to key 0.  Tiles inside the range may still hold no
// visible pair (between the prefix and the window).
__device__ __forceinline__ void key_tiles(int r_lo, int r_hi, int S, int bk, int causal,
                                          int window, int pl, int* begin, int* end) {
  *begin = 0;
  *end = (S + bk - 1) / bk;
  if (causal) *end = min(*end, max(r_hi / bk + 1, (pl + bk - 1) / bk));
  if (window > 0 && pl == 0) {
    const int lo = r_lo - window + 1;  // the smallest key the first row sees
    if (lo > 0) *begin = lo / bk;
  }
}

// [begin, end) of the query tiles of ``bq`` rows that see keys k_lo .. k_hi
// (k_hi < S): every tile when the first key is a prefix key, else from the
// diagonal under causal, to the last key's window end under a window.
__device__ __forceinline__ void query_tiles(int k_lo, int k_hi, int S, int bq, int causal,
                                            int window, int pl, int* begin, int* end) {
  *begin = 0;
  *end = (S + bq - 1) / bq;
  if (k_lo < pl) return;
  if (causal) *begin = k_lo / bq;
  if (window > 0) *end = min(*end, (k_hi + window - 1) / bq + 1);
}

}  // namespace repro_torch

// Message for a cudaError_t code returned by an entry point.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
