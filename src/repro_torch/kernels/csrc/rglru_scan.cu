// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// over (B, S, W), starting from h0 (B, W), with the carry in f32; and, run
// in reverse, its adjoint for the backward.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (rglru_scan_fwd, pallas_call at :59, _kernel at :27).  The JAX package
// has no Pallas backward (it differentiates its associative scan); the
// reverse mode here is the port's gradient on the card.
//
// Bound on the H100: memory.  The forward reads a and b once and writes h
// once (12 bytes per element in f32) for a few flops; the reverse reads a,
// dh and h once and writes da and db once (20 bytes per element).  At the
// recurrentgemma-2b train shape (2, 2048, 2560) that is 0.038 / 0.063 ms at
// 3.35 TB/s.  The recurrence is sequential in S and independent across
// (batch row, channel).
//
// What the design does about it.  S is cut into chunks of L steps so that
// the card fills with blocks instead of long dependent chains:
// * Grid: (channel tile of Wt channels x K chunk blocks, batch row).  The K
//   <= 8 blocks of one (row, tile) are one thread-block cluster (launched
//   with cudaLaunchKernelEx's cluster attribute) and hold K consecutive
//   chunks; when S > K * L the cluster loops over groups of K chunks.  One
//   thread per channel.  The plan (L, Wt, K, stages) comes from the
//   wrapper's planner: up to S = 128 one chunk in a cluster of one (no
//   summary, no fold: measured faster at the serve shape than any
//   cluster), beyond it a full cluster of 8 sized with
//   cudaOccupancyMaxActiveClusters (320 blocks at the train shape, where a
//   thread per (row, channel) down all of S gives 40).
// * Loads: each block's chunk tile (a and b; in reverse a with one halo
//   step, dh, and h one step back) lands in shared memory once, by TMA
//   (3-D tensor maps over the caller's strides; zeros outside [0, S) and
//   past W) when every pointer and stride is 16-byte aligned, else by plain
//   per-thread loads.  The wrapper picks the route from the operands and
//   reports it; a map that fails to encode is an error, not a fallback.
//   With more than one group there are two stages, and the next group's
//   loads are issued before this group's cluster barrier.
// * Summary: each thread folds its chunk into the affine map h -> A h + H
//   (A = prod a_t, H = the chunk's scan from 0), a rounded multiply then a
//   rounded add in time order, and writes (A, H) to shared memory.
// * Carry: after a cluster barrier, each block reads the group's summaries
//   through distributed shared memory and folds them onto the group's
//   incoming carry in chunk order 0..rank-1; folding the rest gives the
//   next group's carry, the same bits in every block.  The order is fixed,
//   so the output is bitwise the same run to run.
// * Fix-up: the block re-walks its chunk from that carry with the plain
//   version's rounding (__fmul_rn then __fadd_rn, no FMA contraction) from
//   the tile already on chip and writes h.  A single chunk (S <= L) is
//   therefore bit-identical to the sequential walk in f32; longer S rounds
//   only the carry into each chunk differently.
// * Reverse (the backward): chunks walk from S-1 down with coefficient
//   a_{t+1} (a zero past the end, from the tile's halo row) and input dh,
//   so g_t = dh_t + a_{t+1} g_{t+1} with the same summary, fold and
//   re-walk; the epilogue writes db = g and da_t = g_t h_{t-1} (h_{-1} =
//   h0) from the f32 g, and the block holding t = 0 writes dh0 = a_0 g_0.
//
// a and b share one dtype (f32, bf16 or f16); h0 may be any of the three
// and is read as f32; outputs are in a's dtype (dh0 in h0's).  Operands are
// addressed through (batch, step) element strides with a contiguous channel
// dim.  Any S and W.
#include <cooperative_groups.h>

#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxThreads = 128;  // channels per block (Wt) at most
constexpr int kMaxChunk = 128;    // steps per chunk at most (a TMA box is <= 256 rows)
constexpr int kMaxSmem = 232448;  // shared memory a block may use on sm_90
constexpr int kMaxDevices = 64;
// Entry-point codes besides cudaError_t's.
constexpr int kErrTmaEncode = -1;  // cuTensorMapEncodeTiled refused a map
constexpr int kErrPlan = -2;       // the plan does not fit this launch

// Rows of operand ``op``'s tile: the reverse mode's coefficient tile (op 0,
// a) has one halo row for a_{t+1}.
__host__ __device__ inline int tile_rows(bool reverse, int op, int L) {
  return reverse && op == 0 ? L + 1 : L;
}
__host__ __device__ inline size_t round128(size_t n) { return (n + 127) & ~size_t(127); }
__host__ __device__ inline size_t stage_bytes(bool reverse, int L, int Wt, int esz) {
  size_t s = 0;
  for (int op = 0; op < (reverse ? 3 : 2); ++op)
    s += round128((size_t)tile_rows(reverse, op, L) * Wt * esz);
  return s;
}
// Tiles of every stage, then the summaries (A and H, two buffers each, f32)
// and one mbarrier per stage.
__host__ __device__ inline size_t smem_bytes(bool reverse, int L, int Wt, int esz, int stages) {
  return stages * stage_bytes(reverse, L, Wt, esz) + 4 * (size_t)Wt * sizeof(float) +
         2 * sizeof(uint64_t);
}

struct Operand {
  const void* ptr;
  long long sb, ss;  // batch-row and step strides, in elements
};

struct ScanParams {
  Operand x[3];       // forward: a, b; reverse: a, dh, h
  const void* h0;     // (B, W) through h0_sb, in dtype h0_dtype
  long long h0_sb;
  void* y[2];         // forward: h; reverse: da, db
  long long y_sb[2], y_ss[2];
  void* dh0;          // reverse: (B, W) contiguous, in dtype h0_dtype
  int h0_dtype;
  int B, S, W;
  int L, Wt, K, n_chunks, n_groups, stages;
  int tma;
};

__device__ __forceinline__ float load_f32(const void* p, long long i, int dtype) {
  switch (dtype) {
    case kBF16: return to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16: return to_f32(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}
__device__ __forceinline__ void store_f32(void* p, long long i, int dtype, float v) {
  switch (dtype) {
    case kBF16: static_cast<__nv_bfloat16*>(p)[i] = from_f32<__nv_bfloat16>(v); break;
    case kF16: static_cast<__half*>(p)[i] = from_f32<__half>(v); break;
    default: static_cast<float*>(p)[i] = v;
  }
}

template <typename T, bool REV>
__global__ void __launch_bounds__(kMaxThreads)
rglru_scan_kernel(const __grid_constant__ CUtensorMap m0, const __grid_constant__ CUtensorMap m1,
                  const __grid_constant__ CUtensorMap m2, const ScanParams p) {
  constexpr int kOps = REV ? 3 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, L = p.L, Wt = p.Wt, S = p.S;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / K;
  const int row = blockIdx.y;
  const int j = threadIdx.x;
  const int w = tile * Wt + j;
  const bool live = w < p.W;

  const size_t sbytes = stage_bytes(REV, L, Wt, sizeof(T));
  uint32_t tx_bytes = 0;  // what one stage's TMA boxes write (unpadded)
  for (int op = 0; op < kOps; ++op) tx_bytes += tile_rows(REV, op, L) * Wt * sizeof(T);
  float* sum_a = reinterpret_cast<float*>(smem + p.stages * sbytes);  // [2][Wt]
  float* sum_h = sum_a + 2 * Wt;                                       // [2][Wt]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sum_h + 2 * Wt);
  auto tile_of = [&](int stage, int op) {
    size_t off = stage * sbytes;
    for (int o = 0; o < op; ++o) off += round128((size_t)tile_rows(REV, o, L) * Wt * sizeof(T));
    return reinterpret_cast<T*>(smem + off);
  };
  // Time of row 0 of chunk c's tiles (the reverse mode's h tile starts one
  // step earlier: its row r holds h_{t-1} for the t of the other tiles' r).
  auto base = [&](int c) { return REV ? S - (c + 1) * L : c * L; };

  // Chunk g * K + rank's tiles into ``stage`` (a block past the last chunk
  // loads nothing and waits for nothing).
  auto load = [&](int g, int stage) {
    const int c = g * K + rank;
    if (c >= p.n_chunks) return;
    if (p.tma) {
      if (j != 0) return;
      const uint32_t bar = hopper::smem_u32(&bars[stage]);
      hopper::mbar_expect_tx(bar, tx_bytes);
      hopper::tma_load_3d(hopper::smem_u32(tile_of(stage, 0)), &m0, bar, tile * Wt, base(c), row);
      hopper::tma_load_3d(hopper::smem_u32(tile_of(stage, 1)), &m1, bar, tile * Wt, base(c), row);
      if (REV)
        hopper::tma_load_3d(hopper::smem_u32(tile_of(stage, 2)), &m2, bar, tile * Wt, base(c) - 1,
                            row);
      return;
    }
#pragma unroll
    for (int op = 0; op < kOps; ++op) {
      const T* src = static_cast<const T*>(p.x[op].ptr) + row * p.x[op].sb + w;
      T* dst = tile_of(stage, op) + j;
      const int t0 = base(c) - (op == 2 ? 1 : 0);
      const int rows = tile_rows(REV, op, L);
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        dst[r * Wt] = live && t >= 0 && t < S ? src[(long long)t * p.x[op].ss] : from_f32<T>(0.f);
      }
    }
  };

  if (p.tma && j == 0) {
    for (int s = 0; s < p.stages; ++s) hopper::mbar_init(hopper::smem_u32(&bars[s]), 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // A lone chunk (S <= L) walks from h0 (or 0) with no summary and no fold.
  const bool fold = K > 1 || p.n_groups > 1;
  float carry = !REV && live ? load_f32(p.h0, row * p.h0_sb + w, p.h0_dtype) : 0.f;
  load(0, 0);
  for (int g = 0; g < p.n_groups; ++g) {
    const int stage = g % p.stages;
    const int c = g * K + rank;
    const int n = c < p.n_chunks ? min(L, S - c * L) : 0;
    if (p.tma && g + 1 < p.n_groups) {
      __syncthreads();  // every thread is done with the stage refilled here
      if (j == 0) hopper::fence_proxy_async_shared();
      load(g + 1, (g + 1) % p.stages);
    }
    if (p.tma && n > 0) hopper::mbar_wait(hopper::smem_u32(&bars[stage]), (g / p.stages) & 1);
    const T* x0 = tile_of(stage, 0);
    const T* x1 = tile_of(stage, 1);

    // Summary of the chunk: step i is tile row i forward, L - 1 - i in
    // reverse, whose coefficient a_{t+1} is one row further.
    const int buf = g & 1;
    if (fold) {
      float A = 1.f, H = 0.f;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const int r = REV ? L - 1 - i : i;
        const float cv = to_f32(x0[(REV ? r + 1 : r) * Wt + j]);
        A = __fmul_rn(A, cv);
        H = __fadd_rn(__fmul_rn(cv, H), to_f32(x1[r * Wt + j]));
      }
      sum_a[buf * Wt + j] = A;
      sum_h[buf * Wt + j] = H;
    }
    if (!p.tma && g + 1 < p.n_groups) load(g + 1, (g + 1) % p.stages);

    // Carry: the group's summaries in chunk order onto its incoming carry.
    float hin = carry;
    if (fold) {
      cluster.sync();
      const int kv = min(K, p.n_chunks - g * K);
      float ra[kMaxCluster], rh[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < kv) {
          ra[r] = cluster.map_shared_rank(sum_a + buf * Wt, r)[j];
          rh[r] = cluster.map_shared_rank(sum_h + buf * Wt, r)[j];
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < kv) {
          if (r == rank) hin = carry;
          carry = __fadd_rn(__fmul_rn(ra[r], carry), rh[r]);
        }
      }
    }

    // Fix-up: re-walk the chunk from its carry and write the outputs.
    if (n > 0 && live) {
      const T* x2 = tile_of(stage, kOps - 1);
      T* y0 = static_cast<T*>(p.y[0]) + row * p.y_sb[0] + w;
      T* y1 = REV ? static_cast<T*>(p.y[1]) + row * p.y_sb[1] + w : nullptr;
      const int tb = base(c);
      float h = hin;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int r = REV ? L - 1 - i : i;
        const int t = tb + r;
        const float cv = to_f32(x0[(REV ? r + 1 : r) * Wt + j]);
        h = __fadd_rn(__fmul_rn(cv, h), to_f32(x1[r * Wt + j]));
        if (!REV) {
          y0[(long long)t * p.y_ss[0]] = from_f32<T>(h);
        } else {
          const float hp = t == 0 ? load_f32(p.h0, row * p.h0_sb + w, p.h0_dtype)
                                  : to_f32(x2[r * Wt + j]);
          y0[(long long)t * p.y_ss[0]] = from_f32<T>(__fmul_rn(h, hp));
          y1[(long long)t * p.y_ss[1]] = from_f32<T>(h);
          if (t == 0)
            store_f32(p.dh0, (long long)row * p.W + w, p.h0_dtype,
                      __fmul_rn(to_f32(x0[r * Wt + j]), h));
        }
      }
    }
  }
  if (fold) cluster.sync();  // no block leaves while another may read its summaries
}

template <typename T>
CUtensorMapDataType tma_dtype() {
  if (std::is_same<T, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (std::is_same<T, __half>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A 3-D map (W, S, B) over one operand with its element strides, boxes of
// Wt channels x ``rows`` steps of one batch row, no swizzle, zeros outside.
// The stride of a size-1 dim is never used; it is replaced by a packed one.
template <typename T>
bool make_map(CUtensorMap* map, const Operand& x, int W, int S, int B, int Wt, int rows) {
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t esz = sizeof(T);
  cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)x.ss * esz, (cuuint64_t)x.sb * esz};
  if (S == 1) strides[0] = ((cuuint64_t)W * esz + 15) / 16 * 16;
  if (B == 1) strides[1] = strides[0] * (cuuint64_t)S;
  cuuint32_t box[3] = {(cuuint32_t)Wt, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, tma_dtype<T>(), 3, const_cast<void*>(x.ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int K, int n_tiles, int B,
                    int Wt, size_t smem, cudaStream_t st) {
  std::memset(cfg, 0, sizeof(*cfg));
  cfg->gridDim = dim3(K * n_tiles, B, 1);
  cfg->blockDim = dim3(Wt, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Returns ``err`` after clearing it from the runtime's last error, so that a
// refused call does not surface later in someone else's launch check.
int failed(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

// Lets the (T, REV) kernel use all the shared memory a block may have, once
// per device.
template <typename T, bool REV>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(rglru_scan_kernel<T, REV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, bool REV>
int launch(ScanParams p, long long smem_planned, cudaStream_t st) {
  const size_t smem = smem_bytes(REV, p.L, p.Wt, sizeof(T), p.stages);
  if ((long long)smem != smem_planned) return kErrPlan;
  CUtensorMap maps[3];
  std::memset(maps, 0, sizeof(maps));
  if (p.tma) {
    for (int op = 0; op < (REV ? 3 : 2); ++op)
      if (!make_map<T>(&maps[op], p.x[op], p.W, p.S, p.B, p.Wt, tile_rows(REV, op, p.L)))
        return kErrTmaEncode;
  }
  auto kernel = rglru_scan_kernel<T, REV>;
  cudaError_t err = allow_smem<T, REV>();
  if (err != cudaSuccess) return failed(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, p.K, (p.W + p.Wt - 1) / p.Wt, p.B, p.Wt, smem, st);
  void* args[] = {&maps[0], &maps[1], &maps[2], &p};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  return err != cudaSuccess ? failed(err) : (int)cudaGetLastError();
}

template <typename T, bool REV>
int active_clusters(int L, int Wt, int K, int stages, int* out) {
  const size_t smem = smem_bytes(REV, L, Wt, sizeof(T), stages);
  auto kernel = rglru_scan_kernel<T, REV>;
  cudaError_t err = allow_smem<T, REV>();
  if (err != cudaSuccess) return failed(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, K, 1, 1, Wt, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(kernel), &cfg);
  return err != cudaSuccess ? failed(err) : 0;
}

template <bool REV>
int dispatch(int dtype, const ScanParams& p, long long smem, cudaStream_t st) {
  switch (dtype) {
    case kF32: return launch<float, REV>(p, smem, st);
    case kBF16: return launch<__nv_bfloat16, REV>(p, smem, st);
    case kF16: return launch<__half, REV>(p, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// One launch of the scan (reverse = 0: x = a, b; y0 = h) or of its adjoint
// (reverse = 1: x = a, dh, h; y0 = da, y1 = db, dh0), with the wrapper's
// plan (L steps a chunk, Wt channels a block, K blocks a cluster, stages)
// and route (tma = 1: TMA loads, else per-thread loads).  ``smem`` is the
// planner's shared-memory size, checked against the kernel's own layout.
// Returns 0, a cudaError_t, -1 (a TMA map did not encode) or -2 (the plan
// does not fit this launch).
extern "C" int rglru_scan_launch(
    int reverse, int dtype, int h0_dtype, int B, int S, int W,
    const void* x0, long long x0_sb, long long x0_ss, const void* x1, long long x1_sb,
    long long x1_ss, const void* x2, long long x2_sb, long long x2_ss,
    const void* h0, long long h0_sb, void* y0, long long y0_sb, long long y0_ss,
    void* y1, long long y1_sb, long long y1_ss, void* dh0,
    int L, int Wt, int K, int stages, int tma, long long smem, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + L - 1) / L;
  const int n_groups = L > 0 && K > 0 ? (n_chunks + K - 1) / K : 0;
  if (L < 1 || L > kMaxChunk || !(Wt == 32 || Wt == 64 || Wt == kMaxThreads) || K < 1 ||
      K > kMaxCluster || K > n_chunks || stages != (n_groups > 1 ? 2 : 1))
    return kErrPlan;
  ScanParams p;
  p.x[0] = {x0, x0_sb, x0_ss};
  p.x[1] = {x1, x1_sb, x1_ss};
  p.x[2] = {x2, x2_sb, x2_ss};
  p.h0 = h0;
  p.h0_sb = h0_sb;
  p.y[0] = y0;
  p.y[1] = y1;
  p.y_sb[0] = y0_sb;
  p.y_ss[0] = y0_ss;
  p.y_sb[1] = y1_sb;
  p.y_ss[1] = y1_ss;
  p.dh0 = dh0;
  p.h0_dtype = h0_dtype;
  p.B = B;
  p.S = S;
  p.W = W;
  p.L = L;
  p.Wt = Wt;
  p.K = K;
  p.n_chunks = n_chunks;
  p.n_groups = n_groups;
  p.stages = stages;
  p.tma = tma;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return reverse ? dispatch<true>(dtype, p, smem, st) : dispatch<false>(dtype, p, smem, st);
}

// How many clusters of the (reverse, dtype) kernel with this plan the
// current device holds at once (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int rglru_scan_active_clusters(int reverse, int dtype, int L, int Wt, int K,
                                          int stages, int* out) {
  using namespace repro_torch;
  *out = 0;
  switch (dtype * 2 + (reverse ? 1 : 0)) {
    case kF32 * 2: return active_clusters<float, false>(L, Wt, K, stages, out);
    case kF32 * 2 + 1: return active_clusters<float, true>(L, Wt, K, stages, out);
    case kBF16 * 2: return active_clusters<__nv_bfloat16, false>(L, Wt, K, stages, out);
    case kBF16 * 2 + 1: return active_clusters<__nv_bfloat16, true>(L, Wt, K, stages, out);
    case kF16 * 2: return active_clusters<__half, false>(L, Wt, K, stages, out);
    case kF16 * 2 + 1: return active_clusters<__half, true>(L, Wt, K, stages, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
