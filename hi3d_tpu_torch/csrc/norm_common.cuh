// Pieces shared by the normalisation kernels: LayerNorm rows and GroupNorm
// statistics (norm_stats.cu, #10 and #9) and GroupNorm(+SiLU) (group_norm.cu,
// K3): the dtype codes of ops/build.py, fp32 conversions, the warp sum, the
// SM count, and the fold of a thread-block cluster's partial sums through
// distributed shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (Σx, Σx²) of the cluster: the pair `part` (in shared memory) of every
// rank, read through distributed shared memory and summed in rank order, so
// every rank that folds gets bitwise the same sums. Call after a
// cluster.sync() that follows every rank's write of `part`, and keep each
// rank's shared memory alive (a second cluster barrier) until every reader
// is done.
__device__ __forceinline__ float2 cluster_fold(float* part, int nranks) {
  cg::cluster_group cluster = cg::this_cluster();
  float a = 0.f, c = 0.f;
  for (int r = 0; r < nranks; ++r) {
    const float* rp = cluster.map_shared_rank(part, r);
    a += rp[0];
    c += rp[1];
  }
  return make_float2(a, c);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace
