// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// over (B, S, W), starting from h0 (B, W), with the carry in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (rglru_scan_fwd, pallas_call at :59, _kernel at :27).
//
// Bound on the H100: memory.  Each element of a and b is read once and each
// h written once (12 bytes per element in f32) for one multiply and one
// add, far below the ~20 FLOP/byte the card needs before its f32 rate
// would bound it.  The recurrence is sequential in S and independent
// across (batch row, channel).
//
// What the design does about it: one thread per (batch row, channel), with
// neighbouring threads on neighbouring channels, so every load and store of
// a warp is one contiguous run of 32 elements (coalesced).  Each thread
// walks S in order and keeps h in an f32 register (the Pallas kernel's VMEM
// carry); it issues the loads of the next kU steps of a and b before the
// first dependent multiply-add, so kU steps of loads are in flight per
// thread instead of one.  h is updated as a rounded multiply then a
// rounded add (no FMA contraction), the order of the plain PyTorch
// version, so f32 results agree with it bit for bit.
//
// Unlike the Pallas kernel, S and W need no block multiple (a ragged tail
// of S runs step by step, threads past W exit).  a and b share one dtype
// (f32, bf16 or f16); h0 may be any of the three and is read as f32; h is
// written in a's dtype.  a, b and h are addressed through (batch, seq)
// element strides with a contiguous channel dim.
//
// This simple design has B * ceil(W / 128) blocks: 80 at the served
// (4, 128, 2560) shape and 40 at the training (2, 2048, 2560) shape on 132
// SMs, and each thread's chain of S dependent steps is latency-bound.  A
// chunked-S design (a per-chunk summary, a carry pass, a fix-up pass) is
// the way to more blocks and to the bound.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kU = 16;         // steps whose loads are issued ahead

template <typename T, typename TH>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const TH* __restrict__ h0, T* __restrict__ out, int S, int W,
                  long long a_sb, long long a_ss, long long b_sb, long long b_ss,
                  long long h0_sb, long long o_sb, long long o_ss) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const T* ap = a + row * a_sb + w;
  const T* bp = b + row * b_sb + w;
  T* op = out + row * o_sb + w;
  float h = to_f32(h0[row * h0_sb + w]);
  int t = 0;
  for (; t + kU <= S; t += kU) {
    float av[kU], bv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      av[u] = to_f32(ap[(long long)(t + u) * a_ss]);
      bv[u] = to_f32(bp[(long long)(t + u) * b_ss]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      op[(long long)(t + u) * o_ss] = from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(to_f32(ap[(long long)t * a_ss]), h), to_f32(bp[(long long)t * b_ss]));
    op[(long long)t * o_ss] = from_f32<T>(h);
  }
}

template <typename T, typename TH>
cudaError_t launch(const void* a, const void* b, const void* h0, void* out, int B, int S,
                   int W, long long a_sb, long long a_ss, long long b_sb, long long b_ss,
                   long long h0_sb, long long o_sb, long long o_ss, cudaStream_t st) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T, TH><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const TH*>(h0),
      static_cast<T*>(out), S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_h0(int h0_dtype, const void* a, const void* b, const void* h0, void* out,
                        int B, int S, int W, long long a_sb, long long a_ss, long long b_sb,
                        long long b_ss, long long h0_sb, long long o_sb, long long o_ss,
                        cudaStream_t st) {
  switch (h0_dtype) {
    case kF32:
      return launch<T, float>(a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss, st);
    case kBF16:
      return launch<T, __nv_bfloat16>(a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss, st);
    case kF16:
      return launch<T, __half>(a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int rglru_scan_fwd(
    const void* a, const void* b, const void* h0, void* out, int dtype, int h0_dtype,
    int B, int S, int W, long long a_sb, long long a_ss, long long b_sb, long long b_ss,
    long long h0_sb, long long o_sb, long long o_ss, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = dispatch_h0<float>(h0_dtype, a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss, st);
      break;
    case kBF16:
      err = dispatch_h0<__nv_bfloat16>(h0_dtype, a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss, st);
      break;
    case kF16:
      err = dispatch_h0<__half>(h0_dtype, a, b, h0, out, B, S, W, a_sb, a_ss, b_sb, b_ss, h0_sb, o_sb, o_ss, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
