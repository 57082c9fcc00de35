// Sinkhorn row / column scaling passes in log space.
//
// Replaces the two Pallas TPU kernels of kubernetes_tpu/ops/sinkhorn.py:
//   _u_kernel (:156)  u_i = log_r_i - lse_j(logk_ij + v_j)
//   _v_kernel (:171)  v_j = min(log_c_j - lse_i(logk_ij + u_i), 0)
// with the same max-shifted logsumexp: the shift is clamped at
// NEG_INF = -1e30, the sum gets +1e-30 inside the log, u <= NEG_INF/2 is
// written as NEG_INF and v <= NEG_INF/2 as 0.
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
__device__ __forceinline__ float lse_final(float m, float s) {
  if (m < kNegInf) {
    s = s * expf(m - kNegInf);
    m = kNegInf;
  }
  return logf(s + 1e-30f) + m;
}

// One block per row; the row is read as float4 (the wrapper requires
// n % 4 == 0 and 16-byte aligned logk rows and v).
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
    const float uu = log_r[blockIdx.x] - lse_final(m, s);
    u[blockIdx.x] = uu > kNegInf * 0.5f ? uu : kNegInf;
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

// Fold one column's tile of kVTile terms into its running pair (m, s):
// one rescale when the tile's max exceeds m, then the tile's exps with
// no branch. -inf terms (rows past the end) add exp(-inf) = 0; while m is
// still -inf every term was -inf and nothing is added (no -inf - -inf).
__device__ __forceinline__ void lse_tile(float& m, float& s,
                                         const float (&x)[kVTile]) {
  float tm = x[0];
#pragma unroll
  for (int r = 1; r < kVTile; ++r) tm = fmaxf(tm, x[r]);
  if (tm > m) {
    s *= expf(m - tm);
    m = tm;
  }
  if (m > -INFINITY) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kVTile; ++r) acc += expf(x[r] - m);
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

__device__ __forceinline__ float v_value(float m, float s, float log_c) {
  const float vv = fminf(log_c - lse_final(m, s), 0.0f);
  return vv > kNegInf * 0.5f ? vv : 0.0f;
}

// Block (strip, chunk): lane l owns columns strip*128 + 4l .. +3, warp w
// the chunk's row tiles w, w + 8, ... (tiles of 8 rows, all loads of a
// tile issued before its math). The warps' pairs merge in warp order into
// the block's partial, written to pm/ps[chunk] (row stride npad =
// strips * 128). The last block of a strip to finish (a counter per strip,
// zeroed before the launch) merges the strip's partials in chunk order and
// writes v, so the result does not depend on which block ran when.
template <bool kVec>
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
  if (j0 < n) v[j0] = v_value(fm.x, fs.x, log_c[j0]);
  if (j0 + 1 < n) v[j0 + 1] = v_value(fm.y, fs.y, log_c[j0 + 1]);
  if (j0 + 2 < n) v[j0 + 2] = v_value(fm.z, fs.z, log_c[j0 + 2]);
  if (j0 + 3 < n) v[j0 + 3] = v_value(fm.w, fs.w, log_c[j0 + 3]);
}

}  // namespace

extern "C" int ktt_sinkhorn_u(const void* logk, const void* v,
                              const void* log_r, void* u, int p, int n,
                              void* stream) {
  if (p <= 0 || n <= 0) return 0;
  u_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logk), static_cast<const float*>(v),
      static_cast<const float*>(log_r), static_cast<float*>(u), n);
  return static_cast<int>(cudaGetLastError());
}

// pm, ps: (chunks, strips * 128) f32 scratch; counters: (strips,) int32
// scratch, zeroed here on the stream right before the launch (the caller
// allocates all three); strips = ceil(n / 128); chunk c holds rows
// [c*rows, min((c+1)*rows, p)), every chunk at least one row.
extern "C" int ktt_sinkhorn_v(const void* logk, const void* u,
                              const void* log_c, void* v, void* pm, void* ps,
                              void* counters, int p, int n, int chunks,
                              int rows, void* stream) {
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
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(logk) % 16 == 0)
    v_kernel<true><<<grid, kThreads, 0, st>>>(k, uu, lc, vv, m, s, cnt, p,
                                              n, rows);
  else
    v_kernel<false><<<grid, kThreads, 0, st>>>(k, uu, lc, vv, m, s, cnt, p,
                                               n, rows);
  return static_cast<int>(cudaGetLastError());
}
