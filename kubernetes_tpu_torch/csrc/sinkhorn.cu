// Sinkhorn row / column scaling passes in log space.
//
// Replaces the two Pallas TPU kernels of kubernetes_tpu/ops/sinkhorn.py:
//   _u_kernel (:156)  u_i = log_r_i - lse_j(logk_ij + v_j)
//   _v_kernel (:171)  v_j = min(log_c_j - lse_i(logk_ij + u_i), 0)
// in one of two rules, chosen per launch:
//   Pallas rule (the fixed-iteration scaling): the max shift is clamped
//     at NEG_INF = -1e30, the sum gets +1e-30 inside the log,
//     u <= NEG_INF/2 is written as NEG_INF and v <= NEG_INF/2 as 0;
//   jnp rule (the tolerance-gated loop, which the reference runs with
//     _scale_jnp on every backend, sinkhorn.py:120): the logsumexp of
//     jax.scipy.special.logsumexp (shift = the max, 0 when it is not
//     finite; no +1e-30), a non-finite u written as NEG_INF and a
//     non-finite v as 0. A zero-capacity column keeps its finite
//     v ~ -1e30 here, so it takes no mass; the Pallas rule would reset it
//     to 0.
//
// Bound: bytes. Each pass must read the (P, N) f32 log-kernel once
// (268 MB at 8192 x 8192, about 0.08 ms on an H100 at 3.35 TB/s); one
// exp per element is far below the card's rate. Each thread keeps a
// running (max, sum) pair -- an online logsumexp, rescaling the sum when
// the max grows -- so logk is read exactly once per pass:
//   u pass: one block per row, float4 row reads (n % 4 == 0), pairs
//           merged across the block.
//   v pass: one launch of 512-thread blocks, one an SM. A strip of 128,
//           64 or 32 columns is shared by the 1-16 blocks of one thread
//           block cluster, each a band of the rows, so that a mesh
//           shard's narrow block still spreads over the card; the plan
//           (ops/sinkhorn.py v_plan) keeps the grid to one wave of the
//           clusters the card holds resident, which it reads off the card
//           (a cluster stays inside one GPC: an H100 holds 66 clusters of
//           2 blocks, 15 of 8, 7 of 16). Each thread owns four adjacent
//           columns (16 bytes, neighbouring lanes on neighbouring
//           addresses) and walks its warp's tiles of 4 rows, the next
//           tile's loads issued into a second set of registers before the
//           current one is folded, so the loads never wait on the math
//           and the math never waits on a whole round trip. Per tile and
//           column one max, one rescale and 4 exps, with no branch. The
//           pairs merge in a fixed order: a warp's row groups by shuffles,
//           the block's warps in a tree in shared memory, the cluster's
//           blocks through distributed shared memory (each other rank
//           writes its pair into rank 0's shared memory and arrives on an
//           mbarrier there, then exits; rank 0 merges them in rank order)
//           -- no scratch in global memory, no memset, no atomics, so the
//           result is the same run to run. Rows of any length are taken:
//           when n % 4 != 0 (or logk is not 16-byte aligned) the same
//           kernel reads the four columns as scalars, and columns past n
//           and rows past the block read as -inf.
// The summation order differs from the plain version's, so results agree
// to a few ulps, not bit for bit.
//
// On a node-axis mesh of d > 1 shards the u pass is split at its
// reduction: ktt_sinkhorn_u_partial writes, per row over the shard's
// columns, the shift m and the sum s = sum_j exp(logk_ij + v_j - m) (the
// Pallas rule clamps m at NEG_INF, rescaling s; the jnp rule replaces a
// non-finite m by 0), and the shards' pairs merge into u in plain PyTorch
// (parallel/collectives.lse_combine). Bound: bytes, logk read once (33.6
// MB for a shard's (8192, 1024) block, 10 us at 3.35 TB/s), so the whole
// kernel is a few round trips to memory and its latency is what it must
// hide. A warp owns a row (or, when the rows alone would leave most of the
// card's warp slots empty, wpr = 2-8 warps of a block share a wide row and
// merge in shared memory): a lane issues all 8 float4 loads of its
// 1024-column tile before any arithmetic (128 bytes a lane, 128 KB an SM
// at the four 8-warp blocks an SM the launch bounds keep resident), folds
// them with one max, at most one rescale and 32 exps with no branch, and
// the lanes merge in the 5-step shuffle tree: no __syncthreads and no
// serial merge on the main path. A block walks a tile of rows, the grid
// planned as one wave (ops/sinkhorn.py u_partial_plan), and stages its v
// once in shared memory, so logk is the only stream from HBM. Rows are
// read as float4 when n % 4 == 0, n <= kUSharedCols and logk is 16-byte
// aligned, as scalars with v from global memory otherwise (a shard's block
// can be narrower than four columns). No atomics: two launches give the
// same bits. The v pass is column-local: each shard runs ktt_sinkhorn_v on
// its columns, its plan sized for the shard's block (a (8192, 1024) block
// is 8 strips of 128 columns, each over a cluster of 8 blocks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// Add one term x to the running pair (m, s), s = sum exp(x_k - m).
__device__ __forceinline__ void lse_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

// Merge pair (m2, s2) into (m, s).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else if (m2 > -INFINITY) {
    s += s2 * expf(m2 - m);
  }
}

// log(sum + 1e-30) + m with the shift clamped at NEG_INF, as the Pallas
// kernels compute it: m' = max(m, NEG_INF), sum' = sum * exp(m - m').
template <bool kJnp>
__device__ __forceinline__ float lse_final(float m, float s) {
  if (kJnp) return logf(s) + (isfinite(m) ? m : 0.0f);
  if (m < kNegInf) {
    s = s * expf(m - kNegInf);
    m = kNegInf;
  }
  return logf(s + 1e-30f) + m;
}

// The row potential from its log-sum-exp, in the launch's rule.
template <bool kJnp>
__device__ __forceinline__ float u_value(float m, float s, float log_r) {
  const float uu = log_r - lse_final<kJnp>(m, s);
  if (kJnp) return isfinite(uu) ? uu : kNegInf;
  return uu > kNegInf * 0.5f ? uu : kNegInf;
}

// One block per row; the row is read as float4 (the wrapper requires
// n % 4 == 0 and 16-byte aligned logk rows and v).
template <bool kJnp>
__global__ void __launch_bounds__(kThreads)
u_kernel(const float* __restrict__ logk, const float* __restrict__ v,
         const float* __restrict__ log_r, float* __restrict__ u, int n) {
  const float* row = logk + static_cast<size_t>(blockIdx.x) * n;
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float m = -INFINITY, s = 0.0f;
  for (int j = threadIdx.x; j < (n >> 2); j += blockDim.x) {
    const float4 x = r4[j], w = v4[j];
    lse_add(m, s, x.x + w.x);
    lse_add(m, s, x.y + w.y);
    lse_add(m, s, x.z + w.z);
    lse_add(m, s, x.w + w.w);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
  }
  __shared__ float sm[32], ss[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) { sm[wid] = m; ss[wid] = s; }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (blockDim.x >> 5); ++w) lse_merge(m, s, sm[w], ss[w]);
    u[blockIdx.x] = u_value<kJnp>(m, s, log_r[blockIdx.x]);
  }
}

// ---- v pass ---------------------------------------------------------------

constexpr int kVThreads = 512;    // a block: one an SM
constexpr int kVWarps = kVThreads / 32;
constexpr int kVTile = 4;         // rows a thread loads a tile
constexpr int kVMaxCluster = 16;  // blocks of a strip, at most
// The dynamic shared memory a block asks for: its pairs' merge buffers
// (32 KB), padded to more than half an SM's 227 KB so that one block fits
// an SM -- the plan counts blocks as SMs.
constexpr int kVPairs = 2 * (kVWarps + kVMaxCluster) * 32;  // float4
constexpr int kVSmem = 116 * 1024;
static_assert(kVPairs * 16 <= kVSmem && 2 * kVSmem > 227 * 1024,
              "the pairs fit, and a second block does not");

__device__ __forceinline__ float4 neg_inf4() {
  return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Fold a tile of K terms (a lane's 32 columns of a row) into its running
// pair (m, s): one rescale when the tile's max exceeds m, then the tile's
// exps with no branch. -inf terms (past the end) add exp(-inf) = 0; while
// m is still -inf every term was -inf and nothing is added (no -inf -
// -inf).
template <int K>
__device__ __forceinline__ void lse_tile(float& m, float& s,
                                         const float (&x)[K]) {
  float tm = x[0];
#pragma unroll
  for (int r = 1; r < K; ++r) tm = fmaxf(tm, x[r]);
  if (tm > m) {
    s *= expf(m - tm);
    m = tm;
  }
  if (m > -INFINITY) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < K; ++r) acc += expf(x[r] - m);
    s += acc;
  }
}

// Merge pair (m2, s2) into (m, s) without a branch (so the four columns
// of a thread interleave): both sums rescaled to the larger shift, or to 0
// while both are empty (-inf), so that nothing is -inf - -inf.
__device__ __forceinline__ void lse_join(float& m, float& s, float m2,
                                         float s2) {
  const float nm = fmaxf(m, m2);
  const float sh = nm > -INFINITY ? nm : 0.0f;
  s = s * expf(m - sh) + s2 * expf(m2 - sh);
  m = nm;
}

__device__ __forceinline__ void lse_join4(float4& m, float4& s, float4 m2,
                                          float4 s2) {
  lse_join(m.x, s.x, m2.x, s2.x);
  lse_join(m.y, s.y, m2.y, s2.y);
  lse_join(m.z, s.z, m2.z, s2.z);
  lse_join(m.w, s.w, m2.w, s2.w);
}

// The column potential, in the launch's rule (fminf returns 0 for a NaN
// operand, which either rule writes as 0 anyway).
template <bool kJnp>
__device__ __forceinline__ float v_value(float m, float s, float log_c) {
  const float vv = fminf(log_c - lse_final<kJnp>(m, s), 0.0f);
  if (kJnp) return isfinite(vv) ? vv : 0.0f;
  return vv > kNegInf * 0.5f ? vv : 0.0f;
}

// Fold the block's kVWarps pairs (wm, ws: [warp][lane]) into warp 0's in
// a fixed tree, each warp's own pair (bm, bs) in registers: for h = 8, 4,
// 2, 1, warp w < h merges warp w + h's pair into its own. Every thread of
// the block calls it (it holds the block's barriers).
__device__ __forceinline__ void tree_merge(float4* wm, float4* ws,
                                           float4& bm, float4& bs, int w,
                                           int lane) {
  wm[w * 32 + lane] = bm;
  ws[w * 32 + lane] = bs;
  __syncthreads();
  for (int h = kVWarps / 2; h > 0; h >>= 1) {
    if (w < h) {
      lse_join4(bm, bs, wm[(w + h) * 32 + lane], ws[(w + h) * 32 + lane]);
      wm[w * 32 + lane] = bm;
      ws[w * 32 + lane] = bs;
    }
    __syncthreads();
  }
}

// The cluster's barrier, split: arrive early, wait (acquire) just before
// another block's shared memory is touched. The arrive is relaxed: the one
// write it must publish, rank 0's mbarrier init, has its own fence
// (fence.mbarrier_init.release.cluster).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrive on the mbarrier at `bar` (a shared address of this block) in the
// block of cluster rank `rank`, releasing this thread's earlier writes to
// that block's shared memory.
__device__ __forceinline__ void arrive_remote(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(remote) : "memory");
}

// Wait for phase `parity` of this block's mbarrier at `bar`, acquiring
// what the other blocks of the cluster released with their arrivals.
__device__ __forceinline__ void wait_cluster_arrivals(uint32_t bar,
                                                      uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Fold K terms of one column into its running pair (m, s) without a
// branch, so the four columns of a thread interleave: the new shift is
// max(m, the terms' max) (0 while every term so far was -inf, so that
// nothing is -inf - -inf), the old sum is rescaled by one exp, and the
// terms' exps are summed in a fixed tree.
template <int K>
__device__ __forceinline__ void lse_fold(float& m, float& s,
                                         const float (&x)[K]) {
  float t[K];
#pragma unroll
  for (int r = 0; r < K; ++r) t[r] = x[r];
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1)
#pragma unroll
    for (int r = 0; r < h; ++r) t[r] = fmaxf(t[r], t[r + h]);
  const float nm = fmaxf(m, t[0]);
  const float sh = nm > -INFINITY ? nm : 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r) t[r] = expf(x[r] - sh);
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1)
#pragma unroll
    for (int r = 0; r < h; ++r) t[r] += t[r + h];
  s = s * expf(m - sh) + t[0];
  m = nm;
}

// Block (rank, strip) of a cluster of gridDim.x blocks that share a strip
// of 4 * lanes columns (lanes = 32, 16 or 8 lanes a row segment, so one
// warp load covers 32 / lanes rows); rank r owns rows [r * rows,
// min((r + 1) * rows, p)). Lane l owns columns strip * 4 * lanes +
// 4 * (l % lanes) .. +3 in row group l / lanes; warp w takes the block's
// tiles w, w + kVWarps, ... of kVTile * 32 / lanes rows, each tile's loads
// issued into registers one tile ahead of its math. Terms past the rows
// or the columns read as -inf. A warp's row groups and the block's warps
// merge their pairs in fixed trees, the cluster's blocks in rank order in
// rank 0, which writes v: the same bits every run.
template <bool kVec, bool kJnp>
__global__ void __launch_bounds__(kVThreads, 1)
v_kernel(const float* __restrict__ logk, const float* __restrict__ u,
         const float* __restrict__ log_c, float* __restrict__ v, int p,
         int n, int lanes, int rows) {
  // the block's warps' pairs, then (rank 0) the other ranks' pairs
  extern __shared__ float4 pairs[];
  float4* wm = pairs;
  float4* ws = wm + kVWarps * 32;
  float4* gm = ws + kVWarps * 32;
  float4* gs = gm + kVMaxCluster * 32;
  __shared__ __align__(8) uint64_t gathered;  // rank 0: the others arrive
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int shift = __ffs(lanes) - 1;  // lanes == 1 << shift
  const int groups = 32 >> shift;      // rows one warp load covers
  const int rg = lane >> shift;        // this lane's row group
  const int j0 = blockIdx.y * 4 * lanes + 4 * (lane & (lanes - 1));
  const int first = rank * rows;
  const int end = min(first + rows, p);
  const int tile_rows = kVTile * groups;
  const int band = kVWarps * tile_rows;
  // tiles a warp walks, an even number (two a loop)
  const int tiles = end > first ? (end - first + 2 * band - 1) / (2 * band) * 2
                                : 0;
  // tile t's terms of this thread: its kVTile rows' quads and u values
  const auto load = [&](int t, float4 (&q)[kVTile], float (&uq)[kVTile]) {
    const int base = first + (t * kVWarps + w) * tile_rows;
#pragma unroll
    for (int k = 0; k < kVTile; ++k) {
      const int i = base + k * groups + rg;
      const bool ok = t < tiles && i < end;
      const float* src = logk + static_cast<size_t>(i) * n + j0;
      if (kVec) {
        q[k] = ok && j0 < n ? __ldg(reinterpret_cast<const float4*>(src))
                            : neg_inf4();
      } else {
        q[k] = neg_inf4();
        if (ok && j0 < n) q[k].x = __ldg(src);
        if (ok && j0 + 1 < n) q[k].y = __ldg(src + 1);
        if (ok && j0 + 2 < n) q[k].z = __ldg(src + 2);
        if (ok && j0 + 3 < n) q[k].w = __ldg(src + 3);
      }
      uq[k] = ok ? __ldg(u + i) : 0.0f;
    }
  };
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const auto fold = [&](const float4 (&q)[kVTile],
                        const float (&uq)[kVTile]) {
    float x[4][kVTile];
#pragma unroll
    for (int k = 0; k < kVTile; ++k) {
      x[0][k] = q[k].x + uq[k];
      x[1][k] = q[k].y + uq[k];
      x[2][k] = q[k].z + uq[k];
      x[3][k] = q[k].w + uq[k];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) lse_fold(m[c], s[c], x[c]);
  };

  const uint32_t bar = smem_addr(&gathered);
  if (rank == 0 && tid == 0 && ranks > 1) {
    // every lane of warp 0 of every other rank arrives once
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(32 * (ranks - 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  cluster_arrive();  // rank 0's barrier is initialised; waited on below

  // two register buffers: tile t + 1 loads while tile t is folded
  float4 qa[kVTile], qb[kVTile];
  float ua[kVTile], ub[kVTile];
  load(0, qa, ua);
  for (int t = 0; t < tiles; t += 2) {
    load(t + 1, qb, ub);
    fold(qa, ua);
    load(t + 2, qa, ua);
    fold(qb, ub);
  }

  // a warp's row groups (lanes < 32), then the block's warps
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[c], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[c], o);
      lse_join(m[c], s[c], m2, s2);
    }
  }
  float4 bm = make_float4(m[0], m[1], m[2], m[3]);
  float4 bs = make_float4(s[0], s[1], s[2], s[3]);
  tree_merge(wm, ws, bm, bs, w, lane);

  // then the cluster's blocks: warp 0 of every other rank writes its pair
  // into rank 0's shared memory and arrives on rank 0's barrier, then its
  // block exits; warp 0 of rank 0 waits for them and merges in rank order
  cluster_wait();
  if (w != 0) return;
  if (rank != 0) {
    *cluster.map_shared_rank(gm + rank * 32 + lane, 0) = bm;
    *cluster.map_shared_rank(gs + rank * 32 + lane, 0) = bs;
    arrive_remote(bar, 0);
    return;
  }
  if (ranks > 1) wait_cluster_arrivals(bar, 0);
  for (int r = 1; r < ranks; ++r)
    lse_join4(bm, bs, gm[r * 32 + lane], gs[r * 32 + lane]);
  if (rg != 0) return;
  if (j0 < n) v[j0] = v_value<kJnp>(bm.x, bs.x, log_c[j0]);
  if (j0 + 1 < n) v[j0 + 1] = v_value<kJnp>(bm.y, bs.y, log_c[j0 + 1]);
  if (j0 + 2 < n) v[j0 + 2] = v_value<kJnp>(bm.z, bs.z, log_c[j0 + 2]);
  if (j0 + 3 < n) v[j0 + 3] = v_value<kJnp>(bm.w, bs.w, log_c[j0 + 3]);
}

template <bool kVec, bool kJnp>
cudaError_t allow_v() {
  const auto fn = v_kernel<kVec, kJnp>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kVSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Once per device (function attributes are per device): the shared
// memory above the 48 KB default and clusters of up to 16 blocks, for
// every variant.
cudaError_t v_ready() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::atomic<uint64_t> ready{0};
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (ready.load(std::memory_order_acquire) & bit))
    return cudaSuccess;
  e = allow_v<true, false>();
  if (e == cudaSuccess) e = allow_v<true, true>();
  if (e == cudaSuccess) e = allow_v<false, false>();
  if (e == cudaSuccess) e = allow_v<false, true>();
  if (e == cudaSuccess && bit) ready.fetch_or(bit, std::memory_order_release);
  return e;
}

// A launch of the v kernel in a cluster of `cluster` blocks along x.
cudaLaunchConfig_t v_config(dim3 grid, cudaLaunchAttribute* attr,
                            int cluster, cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kVThreads, 1, 1);
  cfg.dynamicSmemBytes = kVSmem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// ---- split u pass --------------------------------------------------------

constexpr int kUWarps = kThreads / 32;  // warps of a block
constexpr int kUTile = 8;               // float4 a lane loads before math
constexpr int kUTileCols = 1024;        // a warp's tile: 32 lanes x 8 float4
constexpr int kUBlocksPerSm = 4;        // resident blocks the plan counts on
constexpr int kUSharedCols = 8192;      // the float4 route's widest row
static_assert(kUTileCols == 32 * 4 * kUTile, "a tile is 8 float4 a lane");

// The lane's share of one warp tile, plus v, -inf past n: float4 t/4 +
// 32*k + lane with v from the block's copy in shared memory (kVec), else
// the scalar columns t + 32*k + lane with v from global memory. Every load
// of the tile is issued before any arithmetic.
template <bool kVec>
__device__ __forceinline__ void u_tile(const float* __restrict__ row,
                                       const float* __restrict__ v,
                                       const float4* vs, int t, int lane,
                                       int n, float (&x)[4 * kUTile]) {
  if constexpr (!kVec) {
#pragma unroll
    for (int k = 0; k < 4 * kUTile; ++k) {
      const int j = t + 32 * k + lane;
      x[k] = j < n ? __ldg(row + j) : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < 4 * kUTile; ++k) {
      const int j = t + 32 * k + lane;
      if (j < n) x[k] += __ldg(v + j);
    }
  } else {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int n4 = n >> 2, t4 = t >> 2;
    float4 a[kUTile];
#pragma unroll
    for (int k = 0; k < kUTile; ++k) {
      const int j = t4 + 32 * k + lane;
      a[k] = j < n4 ? __ldg(r4 + j) : neg_inf4();
    }
#pragma unroll
    for (int k = 0; k < kUTile; ++k) {
      const int j = t4 + 32 * k + lane;
      const float4 w = j < n4 ? vs[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * k] = a[k].x + w.x;
      x[4 * k + 1] = a[k].y + w.y;
      x[4 * k + 2] = a[k].z + w.z;
      x[4 * k + 3] = a[k].w + w.w;
    }
  }
}

// The split u pass: (m, s) per row over this block's columns. A block of
// kUWarps warps is `groups` = kUWarps / wpr groups of wpr warps; it owns
// rows [blockIdx.x * groups * rows, +groups * rows) and at step it group g
// takes row first + it * groups + g. Warp q of a group walks its row's
// tiles q, q + wpr, ... and the lanes merge in the shuffle tree; with wpr
// > 1 the group's warps merge in shared memory, in warp order.
template <bool kVec, bool kJnp>
__global__ void __launch_bounds__(kThreads, kUBlocksPerSm)
u_partial_kernel(const float* __restrict__ logk, const float* __restrict__ v,
                 float* __restrict__ m_out, float* __restrict__ s_out, int p,
                 int n, int wpr, int rows) {
  extern __shared__ float4 vs[];  // v, when kVec
  __shared__ float gm[kUWarps], gs[kUWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = kUWarps / wpr, g = warp / wpr, q = warp - g * wpr;
  if constexpr (kVec) {
    // scalar copies: v need not be 16-byte aligned
    float* vf = reinterpret_cast<float*>(vs);
    for (int j = threadIdx.x; j < n; j += kThreads) vf[j] = __ldg(v + j);
    __syncthreads();
  }
  const int first = blockIdx.x * groups * rows;
  for (int it = 0; it < rows; ++it) {
    const int i = first + it * groups + g;
    float m = -INFINITY, s = 0.0f;
    if (i < p) {
      const float* row = logk + static_cast<size_t>(i) * n;
      for (int t = q * kUTileCols; t < n; t += wpr * kUTileCols) {
        float x[4 * kUTile];
        u_tile<kVec>(row, v, vs, t, lane, n, x);
        lse_tile(m, s, x);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      lse_merge(m, s, m2, s2);
    }
    if (wpr > 1) {  // the same for the whole block: the barriers are safe
      if (lane == 0) {
        gm[warp] = m;
        gs[warp] = s;
      }
      __syncthreads();
      if (q == 0 && lane == 0)
        for (int w = 1; w < wpr; ++w) lse_merge(m, s, gm[warp + w],
                                                gs[warp + w]);
      __syncthreads();
    }
    if (q != 0 || lane != 0 || i >= p) continue;
    if (kJnp) {
      // the shift of jax.scipy.special.logsumexp: 0 when not finite
      if (!isfinite(m)) {
        s = m == -INFINITY ? 0.0f : NAN;
        m = 0.0f;
      }
    } else if (m < kNegInf) {
      s = m == -INFINITY ? 0.0f : s * expf(m - kNegInf);
      m = kNegInf;
    }
    m_out[i] = m;
    s_out[i] = s;
  }
}

template <bool kVec>
void launch_u_partial(int blocks, cudaStream_t st, const float* k,
                      const float* v, float* m, float* s, int p, int n,
                      int wpr, int rows, int jnp_rule) {
  const size_t smem = kVec ? sizeof(float) * n : 0;
  if (jnp_rule)
    u_partial_kernel<kVec, true><<<blocks, kThreads, smem, st>>>(
        k, v, m, s, p, n, wpr, rows);
  else
    u_partial_kernel<kVec, false><<<blocks, kThreads, smem, st>>>(
        k, v, m, s, p, n, wpr, rows);
}

}  // namespace

// jnp_rule: 0 = the Pallas rule, else the jnp rule (see the header).
extern "C" int ktt_sinkhorn_u(const void* logk, const void* v,
                              const void* log_r, void* u, int p, int n,
                              int jnp_rule, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(logk);
  const float* vv = static_cast<const float*>(v);
  const float* lr = static_cast<const float*>(log_r);
  float* uu = static_cast<float*>(u);
  if (jnp_rule)
    u_kernel<true><<<p, kThreads, 0, st>>>(k, vv, lr, uu, n);
  else
    u_kernel<false><<<p, kThreads, 0, st>>>(k, vv, lr, uu, n);
  return static_cast<int>(cudaGetLastError());
}

// lanes a row segment (32, 16 or 8: strips of 4 * lanes columns),
// blocks a cluster along the rows (1-16) and rows a block, from the
// wrapper's plan (ops/sinkhorn.py v_plan), covering every row; jnp_rule as
// for the u pass. The launch is the only operation queued.
extern "C" int ktt_sinkhorn_v(const void* logk, const void* u,
                              const void* log_c, void* v, int p, int n,
                              int lanes, int cluster, int rows,
                              int jnp_rule, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  if ((lanes != 32 && lanes != 16 && lanes != 8) || cluster < 1 ||
      cluster > kVMaxCluster ||
      rows <= 0 || static_cast<long long>(cluster) * rows < p)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (n + 4 * lanes - 1) / (4 * lanes);
  if (strips > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = v_ready();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      v_config(dim3(cluster, strips, 1), &attr, cluster,
               static_cast<cudaStream_t>(stream));
  const float* k = static_cast<const float*>(logk);
  const float* uu = static_cast<const float*>(u);
  const float* lc = static_cast<const float*>(log_c);
  float* vv = static_cast<float*>(v);
  // 16-byte copies need n % 4 == 0 and a 16-byte aligned logk; u is copied
  // a value at a time, so its alignment is free
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(logk) % 16 == 0;
  if (vec && jnp_rule)
    e = cudaLaunchKernelEx(&cfg, v_kernel<true, true>, k, uu, lc, vv, p, n,
                           lanes, rows);
  else if (vec)
    e = cudaLaunchKernelEx(&cfg, v_kernel<true, false>, k, uu, lc, vv, p, n,
                           lanes, rows);
  else if (jnp_rule)
    e = cudaLaunchKernelEx(&cfg, v_kernel<false, true>, k, uu, lc, vv, p, n,
                           lanes, rows);
  else
    e = cudaLaunchKernelEx(&cfg, v_kernel<false, false>, k, uu, lc, vv, p,
                           n, lanes, rows);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// clusters: (kVMaxCluster,) int32 output. Entry c - 1: how many clusters
// of c blocks of the v kernel the current device keeps resident at once
// (0 where that size cannot launch: above 8 is beyond the portable
// limit). The wrapper caches it per device.
extern "C" int ktt_sinkhorn_v_fit(void* clusters) {
  cudaError_t e = v_ready();
  if (e != cudaSuccess) return static_cast<int>(e);
  int* out = static_cast<int*>(clusters);
  for (int cs = 1; cs <= kVMaxCluster; ++cs) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        v_config(dim3(cs, 1, 1), &attr, cs, nullptr);
    int got = 0;
    e = cudaOccupancyMaxActiveClusters(
        &got, reinterpret_cast<const void*>(&v_kernel<true, false>), &cfg);
    if (e != cudaSuccess) {
      if (cs <= 8) return static_cast<int>(e);  // a portable size
      (void)cudaGetLastError();
      got = 0;
    }
    out[cs - 1] = got;
  }
  return 0;
}

// m, s: (p,) f32 outputs; wpr warps a row (1, 2, 4 or 8), rows per group
// and blocks from the wrapper's plan (ops/sinkhorn.py u_partial_plan),
// covering every row; jnp_rule as for the u pass.
extern "C" int ktt_sinkhorn_u_partial(const void* logk, const void* v,
                                      void* m, void* s, int p, int n,
                                      int wpr, int rows, int blocks,
                                      int jnp_rule, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  if (wpr <= 0 || kUWarps % wpr != 0 || rows <= 0 || blocks <= 0 ||
      static_cast<long long>(blocks) * (kUWarps / wpr) * rows < p)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(logk);
  const float* vv = static_cast<const float*>(v);
  float* mm = static_cast<float*>(m);
  float* sm = static_cast<float*>(s);
  // float4 rows need n % 4 == 0 and a 16-byte aligned logk; v is staged
  // into shared memory with scalar copies, so its alignment is free
  if (n % 4 == 0 && n <= kUSharedCols &&
      reinterpret_cast<uintptr_t>(logk) % 16 == 0)
    launch_u_partial<true>(blocks, st, k, vv, mm, sm, p, n, wpr, rows,
                           jnp_rule);
  else
    launch_u_partial<false>(blocks, st, k, vv, mm, sm, p, n, wpr, rows,
                            jnp_rule);
  return static_cast<int>(cudaGetLastError());
}
