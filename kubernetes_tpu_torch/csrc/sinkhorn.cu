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
// running (max, sum) pair — an online logsumexp, rescaling the sum when
// the max grows — so logk is read exactly once per pass:
//   u pass: one block per row, float4 row reads (n % 4 == 0), pairs
//           merged across the block;
//   v pass: threads own adjacent columns (row reads coalesce), the rows
//           are cut into chunks, each (chunk, column) writes a partial
//           pair, and a second small kernel merges a column's partials.
// The summation order differs from the plain version's, so results agree
// to a few ulps, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

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

// Partial (max, sum) of column j over rows [chunk*rows, (chunk+1)*rows).
__global__ void __launch_bounds__(kThreads)
v_partial_kernel(const float* __restrict__ logk, const float* __restrict__ u,
                 float* __restrict__ pm, float* __restrict__ ps, int p,
                 int n, int rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int i0 = blockIdx.y * rows;
  const int i1 = min(i0 + rows, p);
  float m = -INFINITY, s = 0.0f;
  for (int i = i0; i < i1; ++i)
    lse_add(m, s, logk[static_cast<size_t>(i) * n + j] + u[i]);
  pm[static_cast<size_t>(blockIdx.y) * n + j] = m;
  ps[static_cast<size_t>(blockIdx.y) * n + j] = s;
}

__global__ void __launch_bounds__(kThreads)
v_finish_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                const float* __restrict__ log_c, float* __restrict__ v,
                int n, int chunks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float m = -INFINITY, s = 0.0f;
  for (int c = 0; c < chunks; ++c)
    lse_merge(m, s, pm[static_cast<size_t>(c) * n + j],
              ps[static_cast<size_t>(c) * n + j]);
  const float vv = fminf(log_c[j] - lse_final(m, s), 0.0f);
  v[j] = vv > kNegInf * 0.5f ? vv : 0.0f;
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

extern "C" int ktt_sinkhorn_v(const void* logk, const void* u,
                              const void* log_c, void* v, void* pm, void* ps,
                              int p, int n, int chunks, int rows,
                              void* stream) {
  if (p <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads, chunks);
  v_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(logk), static_cast<const float*>(u),
      static_cast<float*>(pm), static_cast<float*>(ps), p, n, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  v_finish_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<const float*>(log_c), static_cast<float*>(v), n, chunks);
  return static_cast<int>(cudaGetLastError());
}
