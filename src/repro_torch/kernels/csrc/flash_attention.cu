// Flash-attention forward for Hopper (sm_90a): online-softmax attention over
// K/V tiles, f32 accumulation, GQA by kv head = q head / G.  Two kernels,
// chosen by dtype and head dim (the wrapper's ``flash_route`` says which):
//
// * flash_fwd_wgmma_kernel: bf16 / f16 at D = 64, 128, 256, every shape
//   the full-width paths run (prefill and training).  Tensor cores.
// * flash_fwd_kernel: f32 at any D (TF32 would break the f32 tolerance of
//   1e-4 that the f32 model checks hold), and bf16 / f16 at D = 16, 32, 80
//   and 96 (phi3-mini's 96 and hubert's 80 are not whole 64-wide swizzle
//   boxes).  CUDA cores; shared memory at D = 96 is 90,880 bytes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, pallas_call at :119, _kernel at :30).
//
// Bound on the H100: operations.  At the gemma-2b train shape, q (2, 8,
// 2048, 256) causal, the two products are 4 * B * NQ * D * S(S+1)/2 = 34.4
// GFLOP against 25 MB of q, k, v and out: 0.035 ms at 989 TFLOP/s, 0.008 ms
// at 3.35 TB/s.  At the serve prefill (S = 128, D = 128) both bounds are a
// few microseconds, so launch and pipeline fill dominate.  The CUDA-core
// kernel did both products in f32 FMAs, far from the tensor-core roofline
// (3.7 ms at the train shape, 1 % of the bound).
//
// What the tensor-core kernel does about it.  A block owns 128 query rows
// of one (batch, q head): two consumer warpgroups of 64 rows each and one
// producer warpgroup.
// * Loads: one thread of the producer warpgroup issues TMA tile loads (4-D tensor maps over
//   (D, S, heads, batch) with the caller's byte strides, so the model's
//   (B, S, N, HD) views are read in place) into a ring of K/V stages with
//   full / empty mbarriers; the next tile's K and V land while this one is
//   multiplied.  Q is loaded once.  TMA fills rows past S with zeros.
// * Products: S = Q.K^T is wgmma m64n64k16 with both operands in shared
//   memory (K stored keys x D, D contiguous: K-major).  The f32 scores are
//   masked (only on tiles that straddle the band or the end of S), put
//   through the online softmax in registers, converted to bf16 / f16 and
//   fed straight back as the register A operand of O += P.V (wgmma
//   m64n{64,128}k16, V as the MN-major B operand through the transpose
//   bit): for 16-bit types the accumulator's register order is the A
//   fragment's, so P never goes through shared memory.
// * Tiles: 128-byte swizzle, so a box is 64 elements wide and D = 128 / 256
//   is 2 / 4 boxes side by side; the wgmma descriptors use the same swizzle.
//   Shared memory at D = 256: Q 128 x 256 bf16 = 64 KB plus 2 stages of K
//   and V (64 x 256 each, 32 KB) = 192 KB of the 227 KB a block may use;
//   D <= 128 takes 3 stages (32 + 96 KB / 16 + 48 KB).  Registers per
//   consumer thread at D = 256: the O accumulator 128 f32, the scores 32
//   f32, P 16 x 32-bit, so 64 keys per tile keeps the state within the 240
//   registers setmaxnreg gives each consumer thread (the producer
//   warpgroup drops to 24: 128 * 24 + 256 * 240 <= 65536).  With a lone
//   producer warp and no rebalancing, ptxas held the D = 256 kernel to 168
//   registers and spilled.
// * The tiles a warpgroup's 64 rows cannot see (above the causal diagonal,
//   left of the window) are skipped by that warpgroup; the block's key
//   range uses the kt_begin / kt_end logic of the CUDA-core kernel.
//
// Semantics, both kernels, as the Pallas kernel's: the finite sentinel
// -1e30 for masked scores (a row with no valid key is the mean of v), l
// clamped at 1e-30, the output in q's dtype and an optional f32
// log-sum-exp.  Unlike the Pallas kernel, S need not be a multiple of the
// tile: keys past S get weight exactly 0 and rows past S are not stored.
// Operands are addressed through (batch, head, seq) element strides.  The
// tensor-core kernel needs 16-byte-aligned base pointers and byte strides
// that are multiples of 16 (TMA's rule); the wrapper checks and raises.
#include <type_traits>

#include "hopper.cuh"

namespace repro_torch {
namespace {

// ===========================================================================
// CUDA-core kernel: f32, and bf16 / f16 at D = 16, 32, 80, 96.
// ===========================================================================
namespace cc {


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
  static_assert(smem <= 232448, "shared memory over the 227 KB a block may use");
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

}  // namespace cc

// ===========================================================================
// Tensor-core kernel: bf16 / f16 at D = 64, 128, 256 (wgmma + TMA).
// ===========================================================================
namespace tc {

using namespace hopper;

constexpr int kBQ = 128;               // query rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kConsumerWarps = 8;      // two warpgroups of 64 rows
constexpr int kThreads = kConsumerWarps * 32 + 128;  // + the producer warpgroup
// Registers per thread after setmaxnreg: 128 * 24 + 256 * 240 <= 65536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64;               // box width: 64 16-bit elements = 128 B
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfL2 = kNegInf * kLog2e;  // the sentinel in log2 units

template <int D>
struct Layout {
  static constexpr int kStages = D >= 256 ? 2 : 3;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // full[], empty[], q
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024 B
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, T* __restrict__ out,
                       float* __restrict__ lse, int NQ, int G, int S, Strides3 os, int causal,
                       int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int NST = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 B: align every tile to that.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t bars = base + L::kBar;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (NST + st); };
  const uint32_t q_bar = bars + 8u * (2 * NST);

  // The last query tiles first: under a causal mask they have the most key
  // tiles, so the short ones fill the tail of the grid.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Key tiles this query tile needs (whole tiles outside the band skipped).
  int kt_begin = 0;
  int kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, S) - 1) / kBK + 1);
  if (window > 0) {
    const int lo = q0 - window + 1;  // the smallest key the first row sees
    if (lo > 0) kt_begin = lo / kBK;
  }

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight ----
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j)
        tma_load_4d(q_s + j * (kBQ * 128), &qmap, q_bar, j * kBox, q0, h, b);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty(st), phase ^ 1u);  // the consumers released this stage
        mbar_expect_tx(full(st), 2 * L::kTileBytes);
        const uint32_t k_s = base + L::kK + st * L::kTileBytes;
        const uint32_t v_s = base + L::kV + st * L::kTileBytes;
#pragma unroll
        for (int j = 0; j < L::kBoxes; ++j) {
          tma_load_4d(k_s + j * (kBK * 128), &kmap, full(st), j * kBox, kt * kBK, kvh, b);
          tma_load_4d(v_s + j * (kBK * 128), &vmap, full(st), j * kBox, kt * kBK, kvh, b);
        }
        if (++st == NST) {
          st = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  setmaxnreg_inc<kConsumerRegs>();
  using M = Mma<T>;
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_lo = q0 + 64 * wg;  // this warpgroup's first row
  const int wg_hi = wg_lo + 63;
  const int r0 = wg_lo + 16 * (warp % 4) + lane / 4;  // this thread's rows: r0, r0 + 8

  // O in NC column chunks of NW accumulators (one P.V wgmma each): element
  // e of chunk c is i = c * NW + e, at row r0 + 8 * ((i >> 1) & 1) and
  // column 8 * (i / 4) + 2t + (i & 1).
  constexpr int NC = D == 64 ? 1 : D / 128;
  constexpr int NW = D == 64 ? 32 : 64;
  float o[NC][NW];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < NW; ++e) o[c][e] = 0.f;
  float m0 = kNegInfL2, m1 = kNegInfL2;  // running max (log2 units) of rows r0, r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  const uint32_t q_wg = q_s + wg * (64 * 128);
  mbar_wait(q_bar, 0);

  int st = 0;
  uint32_t phase = 0;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    mbar_wait(full(st), phase);
    // Whole tiles this warpgroup's rows cannot see contribute exactly 0.
    const bool active = wg_lo < S && !(causal && k0 > wg_hi) &&
                        !(window > 0 && k0 + kBK - 1 < wg_lo - window + 1);
    if (active) {
      const uint32_t k_s = base + L::kK + st * L::kTileBytes;
      const uint32_t v_s = base + L::kV + st * L::kTileBytes;
      // S = Q . K^T, 64 x 64 f32, over D in steps of 16.
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32u;  // 16 elements into the 128-byte row
        const uint64_t da = desc_sw128(q_wg + (kk / 4) * (kBQ * 128) + off, 16, 1024);
        const uint64_t db = desc_sw128(k_s + (kk / 4) * (kBK * 128) + off, 16, 1024);
        M::ss64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scale into log2 units; mask only on tiles that straddle the band or S.
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > wg_lo) ||
                        (window > 0 && k0 < wg_hi - window + 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale_log2;
        if (edge) {
          const int row = r0 + 8 * ((i >> 1) & 1);
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          bool ok = true;
          if (causal) ok = ok && row >= col;
          if (window > 0) ok = ok && (row - col) < window;
          x = col >= S ? -INFINITY : (ok ? x : kNegInfL2);  // past S: weight exactly 0
        }
        s[i] = x;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if ((i >> 1) & 1) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the 4 lanes that share a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // Every processed tile holds a key < S, so the new max is finite.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i >> 1) & 1;
        const float p = exp2f(s[i] - (hi ? mn1 : mn0));
        s[i] = p;
        if (hi) ps1 += p;
        else ps0 += p;
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      // P as the A operand: the accumulator order is the fragment order.
      uint32_t pa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kc][r] = M::pack(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < NW; ++e) o[c][e] *= ((e >> 1) & 1) ? c1 : c0;

      // O += P . V over the tile's 64 keys in steps of 16; a chunk of 128
      // columns spans two 64-wide boxes of V (LBO = one box).
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t v_k = v_s + kc * (16 * 128);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const uint64_t db = desc_sw128(v_k + 2 * c * (kBK * 128), kBK * 128, 1024);
          if constexpr (D == 64) M::rs64(o[c], pa[kc], db);
          else M::rs128(o[c], pa[kc], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
    if (++st == NST) {
      st = 0;
      phase ^= 1u;
    }
  }

  // Row sums over the 4 lanes of a row; write O / l and the LSE.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / lc0, inv1 = 1.f / lc1;
  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= S) continue;
    const float inv = half ? inv1 : inv0;
    T* orow = ob + (long long)row * os.s + 2 * t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jj = 0; jj < NW / 4; ++jj) {
        const int e = 4 * jj + 2 * half;
        const int j = (c * NW) / 4 + jj;  // the 8-column block
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = M::pack(o[c][e] * inv, o[c][e + 1] * inv);
      }
    if (lse != nullptr && t == 0)
      lse[((long long)b * NQ + h) * S + row] = ((half ? m1 : m0) + log2f(half ? lc1 : lc0)) * kLn2;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int NQ, int NKV, int S, Strides3 qs, Strides3 ks,
                   Strides3 vs, Strides3 os, int causal, int window, float scale,
                   cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_4d(&qmap, q, dt, D, S, NQ, B, qs.s, qs.h, qs.b, kBQ) ||
      !make_map_4d(&kmap, k, dt, D, S, NKV, B, ks.s, ks.h, ks.b, kBK) ||
      !make_map_4d(&vmap, v, dt, D, S, NKV, B, vs.s, vs.h, vs.b, kBK))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<D>::kAlloc;
  auto kernel = flash_fwd_wgmma_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, NQ, B);
  kernel<<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap, static_cast<T*>(out), lse, NQ,
                                           NQ / NKV, S, os, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

// One kernel per (dtype, D): the tensor-core kernel for 16-bit types at
// D = 64 / 128 / 256, the CUDA-core kernel otherwise (f32, and D = 16, 32,
// 80, 96: the 128-byte swizzle boxes are 64 features wide).
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int NQ, int NKV, int S, Strides3 qs,
                       Strides3 ks, Strides3 vs, Strides3 os, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr bool k16 = !std::is_same<T, float>::value;
#define REPRO_FLASH_ARGS \
  q, k, v, out, lse, B, NQ, NKV, S, qs, ks, vs, os, causal, window, scale, stream
  switch (D) {
    case 16: return cc::launch<T, 16>(REPRO_FLASH_ARGS);
    case 32: return cc::launch<T, 32>(REPRO_FLASH_ARGS);
    case 80: return cc::launch<T, 80>(REPRO_FLASH_ARGS);
    case 96: return cc::launch<T, 96>(REPRO_FLASH_ARGS);
    case 64:
      if constexpr (k16) return tc::launch<T, 64>(REPRO_FLASH_ARGS);
      else return cc::launch<T, 64>(REPRO_FLASH_ARGS);
    case 128:
      if constexpr (k16) return tc::launch<T, 128>(REPRO_FLASH_ARGS);
      else return cc::launch<T, 128>(REPRO_FLASH_ARGS);
    case 256:
      if constexpr (k16) return tc::launch<T, 256>(REPRO_FLASH_ARGS);
      else return cc::launch<T, 256>(REPRO_FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_ARGS
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
