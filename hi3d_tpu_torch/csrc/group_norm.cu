// GroupNorm(+SiLU) forward (K3) for Hopper (sm_90a).
//
// Replaces the Pallas kernels hi3d_tpu/ops/group_norm.py:_fused_group_norm_nsc
// (_stats_kernel, then _apply_kernel): per group (n, g) one-pass fp32 Σx and
// Σx², mean = Σx/m, var = max(Σx²/m − mean², 0), the folded affine
// a = γ·rsqrt(var + eps), b = β − mean·a per channel, y = x·a + b in fp32 with
// the optional SiLU before the cast to x's dtype.
//
// What bounds it on the H100: one read of x and one write of y, about 8
// flops an element, so device-memory bandwidth. The TPU kernel carried its
// sums across a sequential grid axis and read x twice; here one launch reads
// x from HBM once wherever the group fits on chip:
// - Layout: x is an (N, C, S1, S2) view with unit stride along S2 and any
//   (n, c, s1) strides; a row is the S2 elements of one (n, c, s1). Contiguous
//   NCHW or NCTHW is S1 = 1 (a group is one run); the UNet's time stack hands
//   over the (B, C, T, H, W) permuted view of a contiguous (B, T, C, H, W)
//   tensor, S1 = T and S2 = H·W (a group is T runs of (C/G)·H·W elements,
//   C·H·W apart), read in place. y is written contiguous (N, C, S1·S2).
// - A group goes to a thread-block cluster of 1–8 CTAs of 256–1024 threads
//   (the planner is `ops.group_norm.plan_group_norm`); rank r owns `chunk`
//   consecutive 16-byte vectors of the group, rows taken in (s1, c) order so
//   that x is read in its runs. The first `res` of them are copied into
//   shared memory by cp.async (all in flight at once); any rest is streamed
//   with 16-byte loads (UNROLL in flight a thread) and summed as it comes.
//   The 2-D norms (thousands of groups of at most 160 KB) keep every vector
//   (res = chunk); the time stacks (at most 128 groups of up to 5 MB, too
//   few CTAs to hide a resident pass) keep none and fill the SMs once with
//   1024-thread CTAs.
// - The CTA's sums go through the warp shuffles and shared memory in a fixed
//   order; after cluster.sync() every rank folds the cluster's sums from its
//   peers' shared memory (distributed shared memory, `cluster_fold`, which #9
//   shares) in rank order, so every rank has bitwise the same statistics. No
//   scratch tensor, no atomics, no second launch: repeatable bit for bit.
// - Apply: the resident vectors from shared memory, the streamed rest read
//   again in reverse order (the lines read last are the likeliest still in
//   L2), each written once with 16-byte stores.
// Where a row or a stride is not a whole number of 16-byte vectors, the same
// kernel works on single elements (VEC = false), correct and slow.
//
// Given statistics: with `stats` ((2, N·G) fp32: the mean of each group, then
// its inv_std) the kernel skips its statistics pass and applies those, one
// read of x and one write of y. The frame-parallel UNet's time stacks use
// it: each rank holds a block of the locations of every frame, #9's
// moments mode gives each rank's partial moments, the ranks combine them,
// and this applies the group's statistics on every rank.

#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "norm_common.cuh"

namespace {

// 256–1024 threads a CTA (the plan's choice), at most 64 registers a thread
// (the launch bounds), so that the SM's registers hold 1024 threads in all
constexpr int GN_MAX_THREADS = 1024;
constexpr int GN_UNROLL = 4;  // loads in flight a thread
constexpr int GN_SMEM_MAX = 232448;  // dynamic shared memory a block may use

// n / d and n % d for 0 ≤ n < 2^31 and 1 ≤ d < 2^31 by a multiply-high:
// q = (umulhi(n, m) + n) >> s, with s = ⌈log2 d⌉ and m = ⌊2^32·(2^s − d)/d⌋ + 1.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_fastdiv(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned fdiv(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct GnArgs {
  long long sN, sC, sS1;  // x's element strides along n, c, s1
  int C, G, cpg, S1, S2;  // channels, groups a sample, channels a group, extents
  int w_dtype;            // γ and β: contiguous (C,), this dtype
  FastDiv vpr;            // vectors a row (S2 / elements a vector)
  FastDiv cpgd;           // cpg
  int gvecs;              // vectors a group: cpg · S1 · vpr
  int chunk;              // vectors a rank owns (the last rank fewer)
  int res;                // of those, the first `res` stay in shared memory
  int nranks;             // CTAs a group: the cluster
  float eps;
  int silu;
  const float* stats;     // given (2, N·G) statistics: mean, then inv_std; null: computed
  int groups;             // N·G
};

__device__ __forceinline__ float param_at(const void* p, int w_dtype, int i) {
  switch (w_dtype) {
    case kF32: return static_cast<const float*>(p)[i];
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return __half2float(static_cast<const __half*>(p)[i]);
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

template <typename T, bool VEC>
struct Access {  // one access: a 16-byte vector, or one element
  static constexpr int N = VEC ? 16 / (int)sizeof(T) : 1;
  using Raw = typename std::conditional<VEC, uint4, T>::type;

  static __device__ __forceinline__ Raw load(const T* p) {
    if constexpr (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
    else return __ldg(p);
  }
  static __device__ __forceinline__ void to_smem(Raw* dst, const T* src) {
    if constexpr (VEC) cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src);
    else *dst = __ldg(src);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&v)[N]) {
    const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(t[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[N]) {
    Raw r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = from_f<T>(v[i]);
    *reinterpret_cast<Raw*>(p) = r;
  }
};

// Vector e of a group → its channel within the group (`cl`) and its element
// offsets from the group's first element in x and in y.
struct Where {
  int cl;
  long long xo, yo;
};

template <int N>
__device__ __forceinline__ Where locate(unsigned e, const GnArgs& a) {
  const unsigned row = fdiv(e, a.vpr);
  const unsigned j = e - row * a.vpr.d;
  const unsigned s1 = fdiv(row, a.cpgd);
  const unsigned cl = row - s1 * a.cpgd.d;
  Where w;
  w.cl = (int)cl;
  w.xo = (long long)cl * a.sC + (long long)s1 * a.sS1 + (long long)j * N;
  w.yo = ((long long)cl * a.S1 + s1) * a.S2 + (long long)j * N;
  return w;
}

template <int N>
__device__ __forceinline__ void accumulate(const float (&v)[N], float& s1, float& s2) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s1 += v[i];
    s2 = fmaf(v[i], v[i], s2);
  }
}

template <int N>
__device__ __forceinline__ void apply(float (&v)[N], float ca, float cb, bool silu) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float z = fmaf(v[i], ca, cb);
    v[i] = silu ? __fdividef(z, 1.f + __expf(-z)) : z;
  }
}

// Shared memory of the resident vectors, rounded up to 16 bytes.
template <typename Raw>
__host__ __device__ __forceinline__ size_t keep_bytes(int res) {
  return ((size_t)res * sizeof(Raw) + 15) & ~(size_t)15;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(GN_MAX_THREADS, 1)
group_norm_kernel(const T* __restrict__ x, T* __restrict__ y, const void* __restrict__ w,
                  const void* __restrict__ b, GnArgs a) {
  using A = Access<T, VEC>;
  using Raw = typename A::Raw;
  constexpr int N = A::N;
  constexpr int U = GN_UNROLL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Raw* keep = reinterpret_cast<Raw*>(smem_raw);  // res vectors, then a and b a channel
  float* coef = reinterpret_cast<float*>(smem_raw + keep_bytes<Raw>(a.res));
  __shared__ float red[2][GN_MAX_THREADS / 32];
  __shared__ float part[2];
  __shared__ float stat[2];

  const int rank = (int)(blockIdx.x % (unsigned)a.nranks);
  const int group = (int)(blockIdx.x / (unsigned)a.nranks);
  const int n = group / a.G, g = group % a.G;
  const T* xg = x + n * a.sN + (long long)g * a.cpg * a.sC;
  T* yg = y + ((long long)n * a.C + (long long)g * a.cpg) * a.S1 * a.S2;
  const int e0 = (int)min((long long)rank * a.chunk, (long long)a.gvecs);
  const int count = (int)min((long long)a.chunk, (long long)a.gvecs - e0);
  const bool given = a.stats != nullptr;
  const int kept = given ? 0 : min(a.res, count);
  const int tid = threadIdx.x, nt = blockDim.x;

  float mean, rstd;
  if (given) {
    mean = a.stats[group];
    rstd = a.stats[a.groups + group];
  } else {
    // resident vectors: every copy in flight at once
    for (int i = tid; i < kept; i += nt) A::to_smem(keep + i, xg + locate<N>(e0 + i, a).xo);
    if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::: "memory");

    // streamed vectors, U loads in flight a thread, summed as they arrive
    float s1 = 0.f, s2 = 0.f;
    for (int i = kept + tid; i < count; i += U * nt) {
      Raw r[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * nt < count) r[u] = A::load(xg + locate<N>(e0 + i + u * nt, a).xo);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i + u * nt < count) {
          float v[N];
          A::unpack(r[u], v);
          accumulate<N>(v, s1, s2);
        }
      }
    }
    if constexpr (VEC) asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int k = tid; k < kept; k += nt) {  // this thread's own copies
      float v[N];
      A::unpack(keep[k], v);
      accumulate<N>(v, s1, s2);
    }

    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if ((tid & 31) == 0) {
      red[0][tid / 32] = s1;
      red[1][tid / 32] = s2;
    }
    __syncthreads();
    if (tid == 0) {
      float p = 0.f, q = 0.f;
      for (int k = 0; k < nt / 32; ++k) {
        p += red[0][k];
        q += red[1][k];
      }
      part[0] = p;
      part[1] = q;
    }
    if (a.nranks > 1) {
      cg::this_cluster().sync();  // every rank's partial sums are in its shared memory
      if (tid == 0) {
        const float2 sums = cluster_fold(part, a.nranks);
        stat[0] = sums.x;
        stat[1] = sums.y;
      }
      // this rank is done reading its peers; it waits at the end of the kernel
      // until every peer is, so that no shared memory goes while being read
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    } else if (tid == 0) {
      stat[0] = part[0];
      stat[1] = part[1];
    }
    __syncthreads();
    const float m = (float)((long long)a.cpg * a.S1 * a.S2);
    mean = stat[0] / m;
    rstd = rsqrtf(fmaxf(stat[1] / m - mean * mean, 0.f) + a.eps);
  }
  for (int c = tid; c < a.cpg; c += nt) {
    const float ca = param_at(w, a.w_dtype, g * a.cpg + c) * rstd;
    coef[2 * c] = ca;
    coef[2 * c + 1] = param_at(b, a.w_dtype, g * a.cpg + c) - mean * ca;
  }
  __syncthreads();

  // apply: the resident vectors, then the streamed rest again in batches of
  // U·nt vectors taken last-read first; U vectors in flight a thread
  const bool silu = a.silu != 0;
  const int streamed = count - kept;
  const int batch = U * nt;
  const int batches = (streamed + batch - 1) / batch;
  for (int it = -((kept + batch - 1) / batch); it < batches; ++it) {
    const bool resident = it < 0;
    const int base = resident ? (it + (kept + batch - 1) / batch) * batch
                              : kept + (batches - 1 - it) * batch;
    const int end = resident ? kept : count;
    Raw r[U];
    Where at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = base + u * nt + tid;
      if (k < end) {
        at[u] = locate<N>(e0 + k, a);
        r[u] = resident ? keep[k] : A::load(xg + at[u].xo);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * nt + tid < end) {
        float v[N];
        A::unpack(r[u], v);
        apply<N>(v, coef[2 * at[u].cl], coef[2 * at[u].cl + 1], silu);
        A::store(yg + at[u].yo, v);
      }
    }
  }
  if (a.nranks > 1 && !given) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, bool VEC>
cudaError_t launch_gn(const void* x, void* y, const void* w, const void* b, const GnArgs& a,
                      int groups, int threads, cudaStream_t stream) {
  using Raw = typename Access<T, VEC>::Raw;
  const size_t smem = keep_bytes<Raw>(a.res) + (size_t)2 * a.cpg * sizeof(float);
  if (smem > (size_t)GN_SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default only by opting in
    // the kernel's ceiling (the opt-in limit less its static shared memory),
    // not this call's size, so that host threads launching concurrently
    // (two-stage serving) never lower it under each other; set once per
    // instance (a thread-safe static; the port drives one card a process)
    static const cudaError_t ceiling = [] {
      cudaFuncAttributes fa;
      cudaError_t e = cudaFuncGetAttributes(&fa, group_norm_kernel<T, VEC>);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(group_norm_kernel<T, VEC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  GN_SMEM_MAX - (int)fa.sharedSizeBytes);
    }();
    if (ceiling != cudaSuccess) return ceiling;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)groups * (unsigned)a.nranks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.nranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.nranks > 1 ? 1 : 0;  // a group a CTA: an ordinary launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, group_norm_kernel<T, VEC>,
                                             static_cast<const T*>(x), static_cast<T*>(y), w, b, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// x: an (N, C, S1, S2) view of dtype `dtype` (0 fp32, 1 bf16, 2 fp16) with
// unit stride along S2 and element strides (sN, sC, sS1); y: contiguous
// (N, C, S1, S2), x's dtype; w, b: contiguous (C,) of w_dtype. G groups of
// C/G channels. vec != 0 promises 16-byte aligned x and y, and S2 and the
// three strides multiples of 16 / sizeof(x) elements; then a vector is 16
// bytes, else one element. cluster (1–8) CTAs a group, each owning `chunk`
// vectors (the last fewer), the first `res` of them kept in shared memory,
// `threads` threads a CTA, as `plan_group_norm` chose them. silu != 0: SiLU
// after the affine. stats != NULL: (2, N·G) fp32 given statistics (the mean of
// each group, then its inv_std) applied without a statistics pass; res must
// then be 0.
extern "C" int hi3d_group_norm(const void* x, void* y, const void* w, const void* b, int N,
                               int C, int G, int S1, int S2, long long sN, long long sC,
                               long long sS1, int dtype, int w_dtype, int vec, int cluster,
                               int chunk, int res, int threads, float eps, int silu,
                               const void* stats, void* stream) {
  if (N < 1 || C < 1 || G < 1 || C % G || S1 < 1 || S2 < 1 || cluster < 1 || cluster > 8 ||
      threads < 32 || threads > GN_MAX_THREADS || threads % 32 ||
      chunk < 1 || res < 0 || res > chunk || w_dtype < kF32 || w_dtype > kF16 ||
      (long long)N * G * cluster > INT_MAX || (stats != nullptr && res != 0))
    return (int)cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  const int per = vec ? 16 / elem : 1;
  if (S2 % per) return (int)cudaErrorInvalidValue;
  GnArgs a;
  a.sN = sN;
  a.sC = sC;
  a.sS1 = sS1;
  a.C = C;
  a.G = G;
  a.cpg = C / G;
  a.S1 = S1;
  a.S2 = S2;
  a.w_dtype = w_dtype;
  a.vpr = make_fastdiv((unsigned)(S2 / per));
  a.cpgd = make_fastdiv((unsigned)a.cpg);
  const long long gvecs = (long long)a.cpg * S1 * (S2 / per);
  if (gvecs >= (1ll << 31) || (long long)chunk * cluster < gvecs) return (int)cudaErrorInvalidValue;
  a.gvecs = (int)gvecs;
  a.chunk = chunk;
  a.res = res;
  a.nranks = cluster;
  a.eps = eps;
  a.silu = silu;
  a.stats = static_cast<const float*>(stats);
  a.groups = N * G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = N * G;
  switch (dtype * 2 + (vec != 0)) {
    case kF32 * 2 + 1: return (int)launch_gn<float, true>(x, y, w, b, a, groups, threads, st);
    case kF32 * 2: return (int)launch_gn<float, false>(x, y, w, b, a, groups, threads, st);
    case kBF16 * 2 + 1:
      return (int)launch_gn<__nv_bfloat16, true>(x, y, w, b, a, groups, threads, st);
    case kBF16 * 2:
      return (int)launch_gn<__nv_bfloat16, false>(x, y, w, b, a, groups, threads, st);
    case kF16 * 2 + 1: return (int)launch_gn<__half, true>(x, y, w, b, a, groups, threads, st);
    case kF16 * 2: return (int)launch_gn<__half, false>(x, y, w, b, a, groups, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
