// LayerNorm rows (#10) and GroupNorm statistics (#9) for Hopper (sm_90a).
//
// #10 replaces the Pallas kernel hi3d_tpu/ops/group_norm.py:_pallas_row_stats_impl
// (_rowstats_kernel): for each row of an (M, C) tensor, one-pass fp32 Σx and
// Σx², mean = Σx/C, var = max(Σx²/C − mean², 0), inv = rsqrt(var + eps). The
// TPU kernel emitted only (mean, inv) and left the apply to XLA, which fused
// it; eager PyTorch fuses nothing, so the same pass here also writes
// y = (x − mean)·inv·γ + β in fp32, cast to x's dtype (y is skipped when the
// caller asks for the statistics alone).
//
// #9 replaces _pallas_group_stats_impl (_gstats_kernel): the same moments per
// group of a contiguous (N, C, *spatial) tensor, where one group is one
// contiguous run of (C/G)·prod(spatial) elements; (mean, inv) are (N, G) fp32.
//
// What bounds both on the H100: one read of x (and one write of y for #10),
// no matrix product, so device-memory bandwidth; at small shapes, the launch.
// Each call is one kernel launched through a plain C entry point, with no
// cast, copy, fill or second pass beside it.
//
// #10: for C ≤ 2048 a row belongs to an aligned group of 4–32 lanes of a warp,
// the fewest that leave at most 6 16-byte vectors a lane (8 at C = 320 bf16,
// 32 at 768 fp32; the port's widths are 320–1280), with the row held in
// registers as loaded; for 2048 < C ≤ 8192, or when there are too few rows
// to fill the card that way, to a 256-thread block. The sums go through
// __shfl_xor_sync (and shared memory across the warps of a block) in a fixed
// order, so a result is bitwise repeatable. γ and β are read in their own
// dtype. x may be a strided view (any row stride); a row that is not 16-byte
// aligned, or a C that is not a multiple of the vector, takes scalar loads and
// stores instead.
//
// #9: a group can hold 4.19 M elements (a 1024² VAE frame at C = 128) while
// N·G is only 32, so a group is split over a thread-block cluster of up to 8
// CTAs (the planner is `ops.group_norm.plan_group_stats`). Each CTA streams
// its contiguous slice with 16-byte loads into fp32 Σx, Σx²; after
// cluster.sync() rank 0 reads the other CTAs' partial sums from their shared
// memory (distributed shared memory) in rank order and writes (mean, inv). No
// scratch tensor, no second launch, no atomics: the result is deterministic.
// The fold (`cluster_fold`, norm_common.cuh) is K3's too (group_norm.cu).
//
// #9's moments mode serves a GroupNorm whose groups are split over the ranks
// of a process group (the frame-parallel UNet's time stacks, each rank
// holding a block of the locations): per group it writes this tensor's
// (mean, M2) in fp32, M2 = Σ(x − mean)², for the ranks to combine exactly
// (Chan's pairwise formula) before K3 applies the statistics. Every CTA of a
// cluster folds the first pass's Σx to the group's mean, streams its slice
// again for Σ(x − m) and Σ(x − m)², and rank 0 folds those: mean = m + Σ(x −
// m)/n, M2 = Σ(x − m)² − (Σ(x − m))²/n. Two reads of x instead of one: a
// one-pass Σx² − n·mean² would lose the variance of a group whose mean is
// large against its spread, and the ranks' sums cannot be shifted by a
// common mean they do not know.

#include <limits.h>
#include <stdint.h>

#include "norm_common.cuh"

namespace {

constexpr int THREADS = 256;     // threads a block: #9, and #10 with a block a row
constexpr int ROW_THREADS = 128;  // threads a block of #10 with 4–32 lanes a row
constexpr int WARP_MAX_C = 2048;
constexpr int MAX_C = 8192;

// N consecutive elements at p as fp32: one vector load of N·sizeof(T) bytes
// (8, or 16-byte pieces) when `vec` (p then aligned to min(16, N·sizeof(T))
// and all N in range), else scalar loads of the first `valid` and zeros.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&out)[N], bool vec,
                                     int valid) {
  constexpr int BYTES = N * sizeof(T);
  static_assert(BYTES == 8 || BYTES % 16 == 0, "vector of 8 or 16·k bytes");
  if (vec) {
    if constexpr (BYTES == 8) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = to_f(t[i]);
    } else {
      uint4 raw[BYTES / 16];
#pragma unroll
      for (int k = 0; k < BYTES / 16; ++k) raw[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
      const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = to_f(t[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = i < valid ? to_f(p[i]) : 0.f;
  }
}

// N = 16 / sizeof(T) values to p in T: one 16-byte store when `vec`, else
// scalar stores of the first `valid`.
template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[N], bool vec,
                                      int valid) {
  static_assert(N * sizeof(T) == 16, "one 16-byte vector");
  if (vec) {
    uint4 raw;
    T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < valid) p[i] = from_f<T>(v[i]);
  }
}

// One 16-byte vector of x at p, kept raw (a 16-bit row costs half the
// registers of its fp32 values): one load when `vec`, else the first `valid`
// elements by scalar loads and zeros after them.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ p, bool vec, int valid) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 raw;
  T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) t[i] = i < valid ? p[i] : from_f<T>(0.f);
  return raw;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[16 / sizeof(T)]) {
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) out[i] = to_f(t[i]);
}

// γ or β (dtype w_dtype) at [e0, e0 + N) as fp32, as `load` does.
template <int N>
__device__ __forceinline__ void load_param(const void* p, int w_dtype, int e0, float (&out)[N],
                                           bool vec, int valid) {
  switch (w_dtype) {
    case kF32: load<float, N>(static_cast<const float*>(p) + e0, out, vec, valid); break;
    case kBF16:
      load<__nv_bfloat16, N>(static_cast<const __nv_bfloat16*>(p) + e0, out, vec, valid);
      break;
    default: load<__half, N>(static_cast<const __half*>(p) + e0, out, vec, valid); break;
  }
}

// #10. `lanes` threads own a row: an aligned group of 4–32 lanes of a warp,
// ROW_THREADS / lanes rows a block, or with BLOCK_ROW a block of THREADS. Thread
// t of a row holds the vectors k·lanes + t, k < NV, of VEC = 16 / sizeof(T)
// elements each, in registers as loaded. y == nullptr: statistics only;
// mean_out == nullptr: y only.
template <typename T, int NV, bool BLOCK_ROW>
__global__ void __launch_bounds__(THREADS)
norm_rows_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ w,
                 const void* __restrict__ b, int w_dtype, float* __restrict__ mean_out,
                 float* __restrict__ inv_out, long long M, int C, long long stride_x, int lanes,
                 bool vec, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  if (BLOCK_ROW) lanes = THREADS;
  const int tid = threadIdx.x & (lanes - 1);
  const long long row =
      BLOCK_ROW ? (long long)blockIdx.x
                : (long long)blockIdx.x * (ROW_THREADS / lanes) + threadIdx.x / lanes;
  // the lanes of a row past M load and store nothing but join the shuffles
  const bool live = row < M;
  const T* xr = x + row * stride_x;

  uint4 raw[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (k * lanes + tid) * VEC;
    raw[k] = live && e0 < C ? load_raw<T>(xr + e0, vec, C - e0) : make_uint4(0, 0, 0, 0);
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float v[VEC];
    unpack<T>(raw[k], v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1 += v[i];
      s2 = fmaf(v[i], v[i], s2);
    }
  }
  // xor offsets below the row's lane count stay inside its aligned lane group
  for (int o = min(lanes, 32) / 2; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if constexpr (BLOCK_ROW) {
    constexpr int WARPS = THREADS / 32;
    __shared__ float red[2][WARPS];
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = s1;
      red[1][warp] = s2;
    }
    __syncthreads();
    s1 = 0.f;
    s2 = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      s1 += red[0][i];
      s2 += red[1][i];
    }
  }
  if (!live) return;
  const float mean = s1 / (float)C;
  const float var = fmaxf(s2 / (float)C - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  if (tid == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
  if (y == nullptr) return;

  T* yr = y + row * (long long)C;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e0 = (k * lanes + tid) * VEC;
    if (e0 < C) {
      float v[VEC], g[VEC], bb[VEC], o[VEC];
      unpack<T>(raw[k], v);
      load_param(w, w_dtype, e0, g, vec, C - e0);
      load_param(b, w_dtype, e0, bb, vec, C - e0);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = (v[i] - mean) * inv * g[i] + bb[i];
      store<T, VEC>(yr + e0, o, vec, C - e0);
    }
  }
}

template <typename T, int NV, bool BLOCK_ROW>
cudaError_t launch_rows_nv(const void* x, void* y, const void* w, const void* b, int w_dtype,
                           void* mean, void* inv, long long M, int C, long long stride_x,
                           int lanes, bool vec, float eps, cudaStream_t stream) {
  const int rows = BLOCK_ROW ? 1 : ROW_THREADS / lanes;
  const long long blocks = (M + rows - 1) / rows;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  norm_rows_kernel<T, NV, BLOCK_ROW><<<(unsigned)blocks, BLOCK_ROW ? THREADS : ROW_THREADS, 0,
                                       stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), w, b, w_dtype, static_cast<float*>(mean),
      static_cast<float*>(inv), M, C, stride_x, lanes, vec, eps);
  return cudaGetLastError();
}

// Up to WARP_MAX_C: the fewest lanes a row (4–32) that leave at most 6
// vectors a lane, so that a short row does not idle most of a warp and each
// lane keeps several 16-byte loads in flight; then more lanes a row while
// the grid would have fewer than two blocks an SM (a few hundred rows, as in
// the CLIP towers, are latency-bound); NV rounded up to 2, 4, 6, 8 (fp32:
// also 12, 16). Above WARP_MAX_C, or when even 32 lanes a row leave fewer
// than two blocks an SM: a block a row, MAX_C / (THREADS · VEC) vectors a
// thread.
template <typename T>
cudaError_t launch_rows(const void* x, void* y, const void* w, const void* b, int w_dtype,
                        void* mean, void* inv, long long M, int C, long long stride_x, bool vec,
                        float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const long long min_blocks = 2ll * sm_count();
  const int nvec = (C + VEC - 1) / VEC;
  int lanes = 4;
  while (lanes < 32 && (nvec + lanes - 1) / lanes > 6) lanes *= 2;
  while (lanes < 32 && (M * lanes + ROW_THREADS - 1) / ROW_THREADS < min_blocks) lanes *= 2;
  if (C > WARP_MAX_C || (M * lanes + ROW_THREADS - 1) / ROW_THREADS < min_blocks)
    return launch_rows_nv<T, MAX_C / (THREADS * VEC), true>(x, y, w, b, w_dtype, mean, inv, M,
                                                            C, stride_x, THREADS, vec, eps, st);
  const int per_lane = (nvec + lanes - 1) / lanes;
#define HI3D_ROWS(NV) \
  launch_rows_nv<T, NV, false>(x, y, w, b, w_dtype, mean, inv, M, C, stride_x, lanes, vec, eps, st)
  if (per_lane <= 2) return HI3D_ROWS(2);
  if (per_lane <= 4) return HI3D_ROWS(4);
  if (per_lane <= 6) return HI3D_ROWS(6);
  if constexpr (VEC == 4) {
    if (per_lane <= 8) return HI3D_ROWS(8);
    if (per_lane <= 12) return HI3D_ROWS(12);
    return HI3D_ROWS(16);
  } else {
    return HI3D_ROWS(8);
  }
#undef HI3D_ROWS
}

// #9. Grid: `nranks` CTAs a group (one cluster), group = blockIdx.x / nranks,
// rank = blockIdx.x % nranks. Rank r owns the elements [min(r·chunk, gs),
// min((r + 1)·chunk, gs)) of its group: a scalar head up to the first
// 16-byte boundary, 16-byte vectors (UNROLL in flight a thread), a scalar tail.
constexpr int UNROLL = 8;

// Σ(v − shift) and Σ(v − shift)² of one 16-byte vector into s1, s2 (shift
// 0: the plain sums, bit for bit)
template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float shift, float& s1,
                                           float& s2) {
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) {
    const float v = to_f(t[i]) - shift;
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
}

// This thread's share of Σ(x − shift) and Σ(x − shift)² over the n elements
// at p: a scalar head up to the first 16-byte boundary, 16-byte vectors
// (UNROLL in flight a thread), a scalar tail.
template <typename T>
__device__ __forceinline__ void slice_sums(const T* __restrict__ p, long long n, float shift,
                                           float& s1, float& s2) {
  constexpr int VEC = 16 / sizeof(T);
  const long long head =
      min((long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)), n);
  if (threadIdx.x < head) {
    const float v = to_f(p[threadIdx.x]) - shift;
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
  const uint4* q = reinterpret_cast<const uint4*>(p + head);
  const long long nvec = (n - head) / VEC;
  long long i = threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < nvec; i += UNROLL * THREADS) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldg(q + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) accumulate<T>(raw[u], shift, s1, s2);
  }
  for (; i < nvec; i += THREADS) accumulate<T>(__ldg(q + i), shift, s1, s2);
  const long long tail = head + nvec * VEC + threadIdx.x;  // fewer than VEC remain
  if (tail < n) {
    const float v = to_f(p[tail]) - shift;
    s1 += v;
    s2 = fmaf(v, v, s2);
  }
}

// The CTA's (s1, s2) summed in a fixed order into out[0], out[1] by thread 0
// (through the warp shuffles and red); red is free again after the next
// __syncthreads or cluster barrier.
constexpr int GS_WARPS = THREADS / 32;

__device__ __forceinline__ void block_sums(float s1, float s2, float (&red)[2][GS_WARPS],
                                           float* out) {
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int k = 0; k < GS_WARPS; ++k) {
      a += red[0][k];
      c += red[1][k];
    }
    out[0] = a;
    out[1] = c;
  }
}

// moments == 0: (mean, inv_std) a group. moments != 0: (mean, M2) a group,
// written to mean_out and inv_out (see the notes above).
template <typename T>
__global__ void __launch_bounds__(THREADS)
group_moments_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                     float* __restrict__ inv_out, long long group_size, long long chunk,
                     int nranks, float eps, int moments) {
  __shared__ float red[2][GS_WARPS];
  __shared__ float part[2];
  __shared__ float dev[2];
  __shared__ float shift;
  const int rank = (int)(blockIdx.x % (unsigned)nranks);
  const long long group = blockIdx.x / (unsigned)nranks;
  const long long start = min((long long)rank * chunk, group_size);
  const long long n = min(start + chunk, group_size) - start;
  const T* p = x + group * group_size + start;

  float s1 = 0.f, s2 = 0.f;
  slice_sums<T>(p, n, 0.f, s1, s2);
  block_sums(s1, s2, red, part);
  if (moments) {
    // every rank folds Σx to the group's mean, then sums its slice's
    // deviations from it; rank 0 folds those
    if (nranks > 1) {
      cg::this_cluster().sync();  // every rank's partial sums are in its shared memory
      if (threadIdx.x == 0) shift = cluster_fold(part, nranks).x / (float)group_size;
    } else if (threadIdx.x == 0) {
      shift = part[0] / (float)group_size;
    }
    __syncthreads();
    const float m = shift;
    float d1 = 0.f, d2 = 0.f;
    slice_sums<T>(p, n, m, d1, d2);
    block_sums(d1, d2, red, dev);
    if (nranks > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every rank's deviations are written and its reads of `part` done
      float2 sums;
      if (rank == 0 && threadIdx.x == 0) sums = cluster_fold(dev, nranks);
      cluster.sync();  // no CTA leaves while rank 0 may still read its shared memory
      if (rank == 0 && threadIdx.x == 0) {
        dev[0] = sums.x;
        dev[1] = sums.y;
      }
    }
    if (rank == 0 && threadIdx.x == 0) {
      const float gs = (float)group_size;
      mean_out[group] = m + dev[0] / gs;
      inv_out[group] = fmaxf(dev[1] - dev[0] * dev[0] / gs, 0.f);
    }
    return;
  }
  if (nranks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partial sums are in its shared memory
    float2 sums;
    if (rank == 0 && threadIdx.x == 0) sums = cluster_fold(part, nranks);
    cluster.sync();  // no CTA leaves while rank 0 may still read its shared memory
    if (rank == 0 && threadIdx.x == 0) {
      part[0] = sums.x;
      part[1] = sums.y;
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    const float mean = part[0] / (float)group_size;
    const float var = fmaxf(part[1] / (float)group_size - mean * mean, 0.f);
    mean_out[group] = mean;
    inv_out[group] = rsqrtf(var + eps);
  }
}

template <typename T>
cudaError_t launch_groups(const void* x, void* mean, void* inv, long long groups,
                          long long group_size, long long chunk, int cluster, float eps,
                          int moments, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * cluster));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a group a CTA: an ordinary launch
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, group_moments_kernel<T>, static_cast<const T*>(x),
                         static_cast<float*>(mean), static_cast<float*>(inv), group_size, chunk,
                         cluster, eps, moments);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// x: M rows of C elements (dtype 0 fp32, 1 bf16, 2 fp16), unit column stride,
// row stride stride_x elements; mean, inv: (M,) fp32. With y (contiguous
// (M, C), x's dtype), w and b ((C,) contiguous, w_dtype, both the same) also
// writes y; y == NULL: statistics only; mean == inv == NULL: y only. vec != 0
// promises 16-byte aligned x rows, w and b, and C a multiple of
// 16 / sizeof(x) elements. 1 ≤ C ≤ 8192.
extern "C" int hi3d_layer_norm(const void* x, void* y, const void* w, const void* b, void* mean,
                               void* inv, long long M, int C, long long stride_x, int dtype,
                               int w_dtype, int vec, float eps, void* stream) {
  if (M < 1 || C < 1 || C > MAX_C || w_dtype < kF32 || w_dtype > kF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  switch (dtype) {
    case kF32:
      return (int)launch_rows<float>(x, y, w, b, w_dtype, mean, inv, M, C, stride_x, v, eps, st);
    case kBF16:
      return (int)launch_rows<__nv_bfloat16>(x, y, w, b, w_dtype, mean, inv, M, C, stride_x, v,
                                             eps, st);
    case kF16:
      return (int)launch_rows<__half>(x, y, w, b, w_dtype, mean, inv, M, C, stride_x, v, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x: `groups` contiguous runs of group_size elements (dtype as above); mean,
// inv: (groups,) fp32. cluster (1–8) CTAs a group, each owning `chunk`
// elements of it (the last fewer), as `plan_group_stats` chose them.
// moments != 0: (mean, M2) instead of (mean, inv_std), M2 written to `inv`.
extern "C" int hi3d_group_stats(const void* x, void* mean, void* inv, long long groups,
                                long long group_size, long long chunk, int cluster, int dtype,
                                float eps, int moments, void* stream) {
  if (groups < 1 || group_size < 1 || cluster < 1 || cluster > 8 || chunk < 1 ||
      chunk * cluster < group_size || groups * cluster > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch_groups<float>(x, mean, inv, groups, group_size, chunk, cluster, eps,
                                       moments, st);
    case kBF16:
      return (int)launch_groups<__nv_bfloat16>(x, mean, inv, groups, group_size, chunk, cluster,
                                               eps, moments, st);
    case kF16:
      return (int)launch_groups<__half>(x, mean, inv, groups, group_size, chunk, cluster, eps,
                                        moments, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
