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
//   v pass: one launch. A block owns a strip of 128 columns and a chunk of
//           rows; each thread owns four adjacent columns, read as one
//           float4 (16 bytes, neighbouring lanes on neighbouring
//           addresses), and walks its chunk's rows in tiles of 8 with all
//           8 loads of a tile issued before any arithmetic: 128 bytes in
//           flight per thread, 64 KB per SM at the two blocks an SM the
//           wrapper plans (up to four fit), well above the ~20 KB per SM
//           that covers HBM latency at 3.35 TB/s. Per tile and
//           column one max, at most one rescale and 8 exps with no
//           branch. The warps' pairs merge in shared memory into one
//           partial per (chunk, column); the last block of a strip to
//           finish (an atomic counter per strip after __threadfence,
//           zeroed by a memset the entry point queues right before the
//           kernel) merges the strip's partials in chunk order and
//           writes v, so the result is the same run to run. Rows of any length are
//           taken: when n % 4 != 0 (or logk is not 16-byte aligned) the
//           same kernel reads the four columns as scalars, and columns
//           past n and rows past the chunk read as -inf.
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
// its columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

constexpr int kVWarps = kThreads / 32;  // row groups of a block
constexpr int kVCols = 128;             // a strip: 32 lanes x 4 columns
constexpr int kVTile = 8;               // rows a thread loads before math

__device__ __forceinline__ float4 neg_inf4() {
  return make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
}

// logk[i, j0..j0+3], -inf where the row or a column is out of range. The
// vector form needs n % 4 == 0 and a 16-byte aligned logk.
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ logk,
                                            int i, bool row_ok, int j0,
                                            int n) {
  const float* at = logk + static_cast<size_t>(i) * n + j0;
  if (kVec)
    return row_ok && j0 < n ? __ldg(reinterpret_cast<const float4*>(at))
                            : neg_inf4();
  float4 q = neg_inf4();
  if (row_ok) {
    if (j0 < n) q.x = __ldg(at);
    if (j0 + 1 < n) q.y = __ldg(at + 1);
    if (j0 + 2 < n) q.z = __ldg(at + 2);
    if (j0 + 3 < n) q.w = __ldg(at + 3);
  }
  return q;
}

// Fold a tile of K terms (a column's kVTile rows, or a lane's 32 columns
// of a row) into its running pair (m, s): one rescale when the tile's max
// exceeds m, then the tile's exps with no branch. -inf terms (past the
// end) add exp(-inf) = 0; while m is still -inf every term was -inf and
// nothing is added (no -inf - -inf).
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

__device__ __forceinline__ void lse_merge4(float4& m, float4& s, float4 m2,
                                           float4 s2) {
  lse_merge(m.x, s.x, m2.x, s2.x);
  lse_merge(m.y, s.y, m2.y, s2.y);
  lse_merge(m.z, s.z, m2.z, s2.z);
  lse_merge(m.w, s.w, m2.w, s2.w);
}

// The column potential, in the launch's rule (fminf returns 0 for a NaN
// operand, which either rule writes as 0 anyway).
template <bool kJnp>
__device__ __forceinline__ float v_value(float m, float s, float log_c) {
  const float vv = fminf(log_c - lse_final<kJnp>(m, s), 0.0f);
  if (kJnp) return isfinite(vv) ? vv : 0.0f;
  return vv > kNegInf * 0.5f ? vv : 0.0f;
}

// Block (strip, chunk): lane l owns columns strip*128 + 4l .. +3, warp w
// the chunk's row tiles w, w + 8, ... (tiles of 8 rows, all loads of a
// tile issued before its math). The warps' pairs merge in warp order into
// the block's partial, written to pm/ps[chunk] (row stride npad =
// strips * 128). The last block of a strip to finish (a counter per strip,
// zeroed before the launch) merges the strip's partials in chunk order and
// writes v, so the result does not depend on which block ran when.
template <bool kVec, bool kJnp>
__global__ void __launch_bounds__(kThreads, 4)
v_kernel(const float* __restrict__ logk, const float* __restrict__ u,
         const float* __restrict__ log_c, float* __restrict__ v,
         float* __restrict__ pm, float* __restrict__ ps,
         int* __restrict__ counters, int p, int n, int rows) {
  const int strip = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int j0 = strip * kVCols + 4 * lane;
  const size_t npad = static_cast<size_t>(gridDim.x) * kVCols;
  const int i1 = min((chunk + 1) * rows, p);
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = chunk * rows + wy * kVTile; t < i1; t += kVWarps * kVTile) {
    float4 q[kVTile];
#pragma unroll
    for (int r = 0; r < kVTile; ++r)
      q[r] = load_quad<kVec>(logk, t + r, t + r < i1, j0, n);
    float x[4][kVTile];
#pragma unroll
    for (int r = 0; r < kVTile; ++r) {
      const float ur = t + r < i1 ? __ldg(u + t + r) : 0.0f;
      x[0][r] = q[r].x + ur;
      x[1][r] = q[r].y + ur;
      x[2][r] = q[r].z + ur;
      x[3][r] = q[r].w + ur;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) lse_tile(m[k], s[k], x[k]);
  }

  __shared__ float4 wm[kVWarps][32], ws[kVWarps][32];
  __shared__ int last;
  wm[wy][lane] = make_float4(m[0], m[1], m[2], m[3]);
  ws[wy][lane] = make_float4(s[0], s[1], s[2], s[3]);
  __syncthreads();
  float4* pm4 = reinterpret_cast<float4*>(pm);
  float4* ps4 = reinterpret_cast<float4*>(ps);
  const size_t col4 = static_cast<size_t>(strip) * (kVCols / 4) + lane;
  if (wy == 0) {
    float4 bm = wm[0][lane], bs = ws[0][lane];
    for (int w = 1; w < kVWarps; ++w) lse_merge4(bm, bs, wm[w][lane],
                                                 ws[w][lane]);
    pm4[chunk * (npad / 4) + col4] = bm;
    ps4[chunk * (npad / 4) + col4] = bs;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + strip, 1) == chunks - 1;
  __syncthreads();
  if (!last || wy != 0) return;

  // the strip's last block: merge every chunk's partial in chunk order
  // (loads four chunks ahead, from L2: the other blocks wrote them)
  float4 fm = neg_inf4(), fs = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < chunks; c0 += 4) {
    float4 am[4], as[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c0 + c < chunks) {
        am[c] = __ldcg(pm4 + (c0 + c) * (npad / 4) + col4);
        as[c] = __ldcg(ps4 + (c0 + c) * (npad / 4) + col4);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c0 + c < chunks) lse_merge4(fm, fs, am[c], as[c]);
  }
  if (j0 < n) v[j0] = v_value<kJnp>(fm.x, fs.x, log_c[j0]);
  if (j0 + 1 < n) v[j0 + 1] = v_value<kJnp>(fm.y, fs.y, log_c[j0 + 1]);
  if (j0 + 2 < n) v[j0 + 2] = v_value<kJnp>(fm.z, fs.z, log_c[j0 + 2]);
  if (j0 + 3 < n) v[j0 + 3] = v_value<kJnp>(fm.w, fs.w, log_c[j0 + 3]);
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

// pm, ps: (chunks, strips * 128) f32 scratch; counters: (strips,) int32
// scratch, zeroed here on the stream right before the launch (the caller
// allocates all three); strips = ceil(n / 128); chunk c holds rows
// [c*rows, min((c+1)*rows, p)), every chunk at least one row; jnp_rule as
// for the u pass.
extern "C" int ktt_sinkhorn_v(const void* logk, const void* u,
                              const void* log_c, void* v, void* pm, void* ps,
                              void* counters, int p, int n, int chunks,
                              int rows, int jnp_rule, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  const dim3 grid((n + kVCols - 1) / kVCols, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* k = static_cast<const float*>(logk);
  const float* uu = static_cast<const float*>(u);
  const float* lc = static_cast<const float*>(log_c);
  float* vv = static_cast<float*>(v);
  float* m = static_cast<float*>(pm);
  float* s = static_cast<float*>(ps);
  int* cnt = static_cast<int*>(counters);
  const cudaError_t z =
      cudaMemsetAsync(cnt, 0, sizeof(int) * grid.x, st);
  if (z != cudaSuccess) return static_cast<int>(z);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(logk) % 16 == 0;
  if (vec && jnp_rule)
    v_kernel<true, true><<<grid, kThreads, 0, st>>>(k, uu, lc, vv, m, s, cnt,
                                                    p, n, rows);
  else if (vec)
    v_kernel<true, false><<<grid, kThreads, 0, st>>>(k, uu, lc, vv, m, s,
                                                     cnt, p, n, rows);
  else if (jnp_rule)
    v_kernel<false, true><<<grid, kThreads, 0, st>>>(k, uu, lc, vv, m, s,
                                                     cnt, p, n, rows);
  else
    v_kernel<false, false><<<grid, kThreads, 0, st>>>(k, uu, lc, vv, m, s,
                                                      cnt, p, n, rows);
  return static_cast<int>(cudaGetLastError());
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
