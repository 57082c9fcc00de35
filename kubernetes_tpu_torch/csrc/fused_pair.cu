// Fused NodeAffinity + TaintToleration normalize pair, one kernel.
//
// Replaces the two Pallas TPU kernels of kubernetes_tpu/ops/fused_score.py:
//   _pair_max_kernel (:75)        masked row maxima of both raw scores
//   _pair_scale_kernel (:95)      scale, floor, reverse and weight-combine
// Both run here in ONE launch: a block owns one row, reduces the two
// masked maxima over the row, syncs, then writes
// w_f * floor(10*rf/mxf + 1e-5) + w_r * (10 - floor(10*rr/mxr + 1e-5)).
// f32 max is exact under any association, so the fusion is exact.
//
// On a node-axis mesh of d > 1 shards the maxima must be all-reduced
// across shards between the two passes, so the pair is also built split
// at that seam (the two Pallas kernels' own boundary):
//   ktt_fused_pair_max    masked row maxima of rf and rr over a shard's
//                         column block (masked entries count as 0)
//   ktt_fused_pair_scale  the scaled, weighted sum given the global
//                         maxima, with the mxf <= 0 / mxr <= 0 rules
// Both are simple one-block-per-row kernels, for any row length (float4
// reads when n % 4 == 0 and the rows are 16-byte aligned, scalar reads
// otherwise), with the same per-element arithmetic as the fused kernel,
// so max-then-scale over the shards is bit-identical to the fused pair.
//
// Bound: bytes. The least the function can move is one read of rf, rr
// (f32) and the mask (1 byte) plus one write of out (f32): 13 bytes per
// (pod, node) element, about 0.26 ms at 8192 x 8192 on an H100 at
// 3.35 TB/s. The arithmetic (two divides per element) is far below the
// card's f32 rate.
//
// Two paths, both hand kernels; the wrapper picks one from the row:
//
//   staged (n % 16 == 0, n <= kStagedMaxN, 16-byte aligned rows): the
//     block stages its row of rf, rr and mask (9n bytes, 72 KB at
//     n = 8192) in dynamic shared memory with three TMA 1-D bulk copies
//     that complete on one mbarrier, reduces both maxima from shared
//     memory and writes out from shared memory with streaming stores
//     (st.global.cs, so the output stream does not evict rows other
//     blocks are still reading). Every input byte crosses HBM once: 13
//     bytes per element, the bound's count. Three blocks fit on an SM at
//     n = 8192 (two at n = 12288), so one block's copy overlaps another's
//     arithmetic, and each copy puts a whole row (72 KB) in flight. A
//     bulk copy needs a 16-byte aligned address and a size that is a
//     multiple of 16: the mask row is n bytes, hence n % 16 == 0; narrower
//     or misaligned rows (the smallest bucket, n = 8) take the wide path.
//     Above 48 KB of dynamic shared memory the launch needs
//     cudaFuncAttributeMaxDynamicSharedMemorySize, set in the entry point.
//   wide (every other row, n % 4 == 0): the block reads the row twice as
//     float4 / uchar4, once for the maxima and once to write, and counts
//     on L2 for the second read; when more rows are in flight than L2
//     holds, part of the second read comes from HBM again (up to 21 bytes
//     per element).
//
// Bit identity with the plain version (priorities._fused_pair_normalize)
// needs IEEE round-to-nearest at every step and no contraction of
// multiply-add into FMA: each step uses an explicit __f*_rn intrinsic
// (never a reciprocal multiply: 10*x/mx and 10*x*(1/mx) differ), and the
// translation unit is also built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kStagedThreads = 512;
constexpr int kStagedMaxN = 12288;
// rf + rr (f32) + mask (1 byte) per element
constexpr int kStagedBytesPerElem = 9;

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

// masked-out entries count as 0 (jnp.where(mask, raw, 0.0) then max)
__device__ __forceinline__ float masked_max4(float4 x, uchar4 k) {
  return fmaxf(fmaxf(k.x ? x.x : 0.0f, k.y ? x.y : 0.0f),
               fmaxf(k.z ? x.z : 0.0f, k.w ? x.w : 0.0f));
}

__device__ __forceinline__ float4 pair_value4(float4 x, float4 y, float mxf,
                                              float mxr, float wf,
                                              float wr) {
  float4 r;
  r.x = pair_value(x.x, y.x, mxf, mxr, wf, wr);
  r.y = pair_value(x.y, y.y, mxf, mxr, wf, wr);
  r.z = pair_value(x.z, y.z, mxf, mxr, wf, wr);
  r.w = pair_value(x.w, y.w, mxf, mxr, wf, wr);
  return r;
}

// ---- staged path: TMA bulk copies into shared memory --------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One block per row; the row's rf, rr and mask land in dynamic shared
// memory (rf at 0, rr at 4n, mask at 8n bytes), each byte read from HBM
// once. The wrapper guarantees n % 16 == 0, n <= kStagedMaxN and 16-byte
// aligned base pointers, so every bulk copy is aligned and a multiple of
// 16 bytes. Three blocks an SM (n = 8192) cap a thread at 40 registers.
__global__ void __launch_bounds__(kStagedThreads, 3)
fused_pair_staged_kernel(const float* __restrict__ rf,
                         const float* __restrict__ rr,
                         const unsigned char* __restrict__ mask,
                         float* __restrict__ out, int n, float wf,
                         float wr) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ __align__(8) uint64_t full;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  float* srf = reinterpret_cast<float*>(stage);
  float* srr = srf + n;
  unsigned char* smask = stage + 8 * static_cast<size_t>(n);
  const uint32_t bar = smem_addr(&full);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t fbytes = 4u * static_cast<uint32_t>(n);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(2u * fbytes + static_cast<uint32_t>(n))
                 : "memory");
    bulk_load(srf, rf + base, fbytes, bar);
    bulk_load(srr, rr + base, fbytes, bar);
    bulk_load(smask, mask + base, static_cast<uint32_t>(n), bar);
  }
  mbar_wait(bar, 0);

  const int n4 = n >> 2;
  const float4* a4 = reinterpret_cast<const float4*>(srf);
  const float4* b4 = reinterpret_cast<const float4*>(srr);
  const uchar4* m4 = reinterpret_cast<const uchar4*>(smask);
  float mxf = -INFINITY, mxr = -INFINITY;
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const uchar4 k = m4[j];
    mxf = fmaxf(mxf, masked_max4(a4[j], k));
    mxr = fmaxf(mxr, masked_max4(b4[j], k));
  }
  block_max2(mxf, mxr);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (int j = threadIdx.x; j < n4; j += blockDim.x)
    __stcs(o4 + j, pair_value4(a4[j], b4[j], mxf, mxr, wf, wr));
}

// ---- wide path: two sweeps over global memory ---------------------------

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
  float mxf = -INFINITY, mxr = -INFINITY;
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const uchar4 k = m4[j];
    mxf = fmaxf(mxf, masked_max4(a4[j], k));
    mxr = fmaxf(mxr, masked_max4(b4[j], k));
  }
  block_max2(mxf, mxr);
  for (int j = threadIdx.x; j < n4; j += blockDim.x)
    o4[j] = pair_value4(a4[j], b4[j], mxf, mxr, wf, wr);
}

// ---- split at the max / scale seam (the partitioned solve) --------------

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pair_max_kernel(const float* __restrict__ rf, const float* __restrict__ rr,
                const unsigned char* __restrict__ mask,
                float* __restrict__ mxf_out, float* __restrict__ mxr_out,
                int n) {
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  float mxf = -INFINITY, mxr = -INFINITY;
  if (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(rf + base);
    const float4* b4 = reinterpret_cast<const float4*>(rr + base);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mask + base);
    for (int j = threadIdx.x; j < (n >> 2); j += blockDim.x) {
      const uchar4 k = m4[j];
      mxf = fmaxf(mxf, masked_max4(a4[j], k));
      mxr = fmaxf(mxr, masked_max4(b4[j], k));
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const bool k = mask[base + j] != 0;
      mxf = fmaxf(mxf, k ? rf[base + j] : 0.0f);
      mxr = fmaxf(mxr, k ? rr[base + j] : 0.0f);
    }
  }
  block_max2(mxf, mxr);
  if (threadIdx.x == 0) {
    mxf_out[blockIdx.x] = mxf;
    mxr_out[blockIdx.x] = mxr;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pair_scale_kernel(const float* __restrict__ rf, const float* __restrict__ rr,
                  const float* __restrict__ mxf_in,
                  const float* __restrict__ mxr_in, float* __restrict__ out,
                  int n, float wf, float wr) {
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float mxf = mxf_in[blockIdx.x], mxr = mxr_in[blockIdx.x];
  if (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(rf + base);
    const float4* b4 = reinterpret_cast<const float4*>(rr + base);
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int j = threadIdx.x; j < (n >> 2); j += blockDim.x)
      o4[j] = pair_value4(a4[j], b4[j], mxf, mxr, wf, wr);
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      out[base + j] = pair_value(rf[base + j], rr[base + j], mxf, mxr, wf,
                                 wr);
  }
}

}  // namespace

// Staged path: the caller checks n % 16 == 0, n <= the staged limit and
// 16-byte aligned pointers (kubernetes_tpu_torch/ops/fused_score.py).
extern "C" int ktt_fused_pair_normalize(const void* rf, const void* rr,
                                        const void* mask, void* out, int p,
                                        int n, float wf, float wr,
                                        void* stream) {
  if (p <= 0 || n <= 0) return 0;
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (n % 16 || n > kStagedMaxN || misaligned(rf) || misaligned(rr) ||
      misaligned(mask) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  // once per device (function attributes are per device): allow the
  // largest row's stage above the 48 KB default, and ask for the whole
  // shared-memory carveout
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static std::atomic<uint64_t> ready{0};
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!bit || !(ready.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(fused_pair_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStagedMaxN * kStagedBytesPerElem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          fused_pair_staged_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready.fetch_or(bit, std::memory_order_release);
  }
  const size_t smem = static_cast<size_t>(n) * kStagedBytesPerElem;
  fused_pair_staged_kernel<<<p, kStagedThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rf), static_cast<const float*>(rr),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), n,
      wf, wr);
  return static_cast<int>(cudaGetLastError());
}

// Wide path: any n % 4 == 0 (the caller checks it and the alignment).
extern "C" int ktt_fused_pair_normalize_wide(const void* rf, const void* rr,
                                             const void* mask, void* out,
                                             int p, int n, float wf,
                                             float wr, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  fused_pair_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rf), static_cast<const float*>(rr),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), n,
      wf, wr);
  return static_cast<int>(cudaGetLastError());
}

namespace {
bool vec_rows(int n, std::initializer_list<const void*> ps) {
  if (n % 4) return false;
  for (const void* q : ps)
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  return true;
}
}  // namespace

// The max pass of the split pair: mxf, mxr (p,) f32 over the row block.
extern "C" int ktt_fused_pair_max(const void* rf, const void* rr,
                                  const void* mask, void* mxf, void* mxr,
                                  int p, int n, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(rf);
  const auto* b = static_cast<const float*>(rr);
  const auto* k = static_cast<const unsigned char*>(mask);
  // the mask rows are read as uchar4: 4-byte aligned rows suffice there
  if (vec_rows(n, {rf, rr}) && reinterpret_cast<uintptr_t>(mask) % 4 == 0)
    pair_max_kernel<true><<<p, kThreads, 0, s>>>(
        a, b, k, static_cast<float*>(mxf), static_cast<float*>(mxr), n);
  else
    pair_max_kernel<false><<<p, kThreads, 0, s>>>(
        a, b, k, static_cast<float*>(mxf), static_cast<float*>(mxr), n);
  return static_cast<int>(cudaGetLastError());
}

// The scale pass of the split pair: out (p, n) given the global maxima.
extern "C" int ktt_fused_pair_scale(const void* rf, const void* rr,
                                    const void* mxf, const void* mxr,
                                    void* out, int p, int n, float wf,
                                    float wr, void* stream) {
  if (p <= 0 || n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(rf);
  const auto* b = static_cast<const float*>(rr);
  const auto* x = static_cast<const float*>(mxf);
  const auto* y = static_cast<const float*>(mxr);
  auto* o = static_cast<float*>(out);
  if (vec_rows(n, {rf, rr, out}))
    pair_scale_kernel<true><<<p, kThreads, 0, s>>>(a, b, x, y, o, n, wf, wr);
  else
    pair_scale_kernel<false><<<p, kThreads, 0, s>>>(a, b, x, y, o, n, wf,
                                                    wr);
  return static_cast<int>(cudaGetLastError());
}
