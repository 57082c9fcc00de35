// Fused NodeAffinity + TaintToleration normalize pair, one kernel.
//
// Replaces the two Pallas TPU kernels of kubernetes_tpu/ops/fused_score.py:
//   _pair_max_kernel (:75)        masked row maxima of both raw scores
//   _pair_scale_kernel (:95)      scale, floor, reverse and weight-combine
// Both run here in ONE launch: a block owns whole rows, reduces the two
// masked maxima over the row, syncs, then sweeps the row again to write
// w_f * floor(10*rf/mxf + 1e-5) + w_r * (10 - floor(10*rr/mxr + 1e-5)).
// f32 max is exact under any association, so the fusion is exact; the
// second sweep reads a row the block has just read (it comes from L2).
//
// Bound: bytes. The least the function can move is one read of rf, rr
// (f32) and the mask (1 byte) plus one write of out (f32): 13 bytes per
// (pod, node) element, about 0.26 ms at 8192 x 8192 on an H100 at
// 3.35 TB/s. The arithmetic (two divides per element) is far below the
// card's f32 rate.
//
// Bit identity with the plain version (priorities._fused_pair_normalize)
// needs IEEE round-to-nearest at every step and no contraction of
// multiply-add into FMA: each step uses an explicit __f*_rn intrinsic, and
// the translation unit is also built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max of two values; every thread gets the results.
__device__ __forceinline__ void block_max2(float& a, float& b) {
  __shared__ float sa[32], sb[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  a = warp_max(a);
  b = warp_max(b);
  if (lane == 0) { sa[wid] = a; sb[wid] = b; }
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? sa[lane] : -INFINITY;
    b = lane < nw ? sb[lane] : -INFINITY;
    a = warp_max(a);
    b = warp_max(b);
    if (lane == 0) { sa[0] = a; sb[0] = b; }
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
}

// priorities._idiv(10 * x, mx): floor(10*x / max(mx, 1e-30) + 1e-5)
__device__ __forceinline__ float idiv10(float x, float mx) {
  const float q = __fdiv_rn(__fmul_rn(10.0f, x), fmaxf(mx, 1e-30f));
  return floorf(__fadd_rn(q, 1e-5f));
}

__device__ __forceinline__ float pair_value(float rf, float rr, float mxf,
                                            float mxr, float wf, float wr) {
  const float sf = mxf > 0.0f ? idiv10(rf, mxf) : 0.0f;
  const float sr = mxr > 0.0f ? __fsub_rn(10.0f, idiv10(rr, mxr)) : 10.0f;
  return __fadd_rn(__fmul_rn(wf, sf), __fmul_rn(wr, sr));
}

// Rows are read as float4 / uchar4: the wrapper requires n % 4 == 0 and
// 16-byte aligned f32 rows (4-byte aligned mask rows).
__global__ void __launch_bounds__(kThreads)
fused_pair_kernel(const float* __restrict__ rf, const float* __restrict__ rr,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ out, int n, float wf, float wr) {
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int n4 = n >> 2;
  const float4* a4 = reinterpret_cast<const float4*>(rf + base);
  const float4* b4 = reinterpret_cast<const float4*>(rr + base);
  const uchar4* m4 = reinterpret_cast<const uchar4*>(mask + base);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  // masked-out entries count as 0 (jnp.where(mask, raw, 0.0) then max)
  float mxf = -INFINITY, mxr = -INFINITY;
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const float4 x = a4[j], y = b4[j];
    const uchar4 k = m4[j];
    mxf = fmaxf(mxf, fmaxf(fmaxf(k.x ? x.x : 0.0f, k.y ? x.y : 0.0f),
                           fmaxf(k.z ? x.z : 0.0f, k.w ? x.w : 0.0f)));
    mxr = fmaxf(mxr, fmaxf(fmaxf(k.x ? y.x : 0.0f, k.y ? y.y : 0.0f),
                           fmaxf(k.z ? y.z : 0.0f, k.w ? y.w : 0.0f)));
  }
  block_max2(mxf, mxr);
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const float4 x = a4[j], y = b4[j];
    float4 r;
    r.x = pair_value(x.x, y.x, mxf, mxr, wf, wr);
    r.y = pair_value(x.y, y.y, mxf, mxr, wf, wr);
    r.z = pair_value(x.z, y.z, mxf, mxr, wf, wr);
    r.w = pair_value(x.w, y.w, mxf, mxr, wf, wr);
    o4[j] = r;
  }
}

}  // namespace

extern "C" int ktt_fused_pair_normalize(const void* rf, const void* rr,
                                        const void* mask, void* out, int p,
                                        int n, float wf, float wr,
                                        void* stream) {
  if (p <= 0 || n <= 0) return 0;
  fused_pair_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rf), static_cast<const float*>(rr),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), n,
      wf, wr);
  return static_cast<int>(cudaGetLastError());
}
