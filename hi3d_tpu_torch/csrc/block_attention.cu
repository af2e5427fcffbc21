// Segment-local (block-diagonal) attention, forward and backward, for Hopper
// (sm_90a): frame-axis self-attention over long clips, one segment = the T
// frames of one (batch b, spatial location s, head h).
//
// Replaces the Pallas kernels hi3d_tpu/ops/temporal_attention.py:_fwd3
// (_fwd_kernel) and _bwd3 (_bwd_kernel). The TPU kernels cut the
// location-major token sequence (B·H, S·T, D) into blocks of many segments
// (up to 512 tokens) to keep the 128x128 MXU fed, and mask every score
// outside a query's own segment. Here one thread block owns exactly one
// segment, its whole attention range: no mask beyond the padding to 16
// frames, no online softmax, no atomics. The inputs are strided 5-D views
// (B, S, T, H, D) with the segment along axis 2, so the UNet's (B, T, S, H, D)
// projections go in as transposed views with no copy.
//
// What bounds it on the H100: per segment 4·T·T·D flops (forward) against
// 4·T·D bf16 moved, about T/2 flops a byte (24 at T = 48), far below the
// card's ~295 on tensor cores, so device-memory bandwidth bounds it. On fp32
// CUDA cores (67 TFLOP/s) the crossover is ~20 flops a byte, so both
// products run on tensor cores: WMMA bf16 m16n16k16 tiles, T padded to 16
// with zero rows. One warp owns 16 query rows (Tp/16 warps a block). The
// softmax is fp32 in the exp2 domain, as in the Pallas kernel; P is rounded
// to bf16 before P·V; lse is written in natural-log units. Shared memory per
// block: forward 6·Tp·D + 6·Tp² bytes (35 KB at T = 48, D = 64; 192 KB at
// T = 128, D = 128), backward 8·Tp·D + 4·Tp² + 128·Tp bytes (208 KB at
// T = 128, D = 128). T runs from 2 to 128, D is 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int MAX_T = 128;
constexpr float NEG_BIG = -1e30f;  // not -inf: exp2(-inf - -inf) is NaN
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {  // element strides of a (B, S, T, H, D) view along b, s, t
  long long b, s, t;
};

__device__ __forceinline__ float2 unpack(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__host__ __device__ constexpr int pad16(int t) { return (t + 15) & ~15; }

// The segment's first row: element (b, s, 0, h, 0) of a strided view.
template <typename T>
__device__ __forceinline__ T* seg_base(T* x, const Strides& st, int b, int s, int h, int D) {
  return x + b * st.b + s * st.s + (long long)h * D;
}

// Rows [0, Tp) of a segment into a dense (Tp, D) shared tile, 16 bytes a
// thread; rows from T on are zero.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int T, int Tp) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < Tp * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < T) val = *reinterpret_cast<const uint4*>(src + r * st + c * 8);
    *reinterpret_cast<uint4*>(dst + r * D + c * 8) = val;
  }
}

// A warp writes a 16x16 fp32 tile (row-major, ld 16) as bf16 rows row0.. of a
// segment, scaled by `mul`; lane l takes row l/2, columns (l%2)*8 .. +8 (one
// 16-byte store). Rows from T on are not written.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long st, const float* tile,
                                           int row0, int T, float mul) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c = (lane & 1) * 8;
  if (row0 + r >= T) return;
  const float* src = tile + r * 16 + c;
  uint4 val;
  val.x = pack(src[0] * mul, src[1] * mul);
  val.y = pack(src[2] * mul, src[3] * mul);
  val.z = pack(src[4] * mul, src[5] * mul);
  val.w = pack(src[6] * mul, src[7] * mul);
  *reinterpret_cast<uint4*>(dst + (row0 + r) * st + c) = val;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ------------------------------------------------------------------ forward
//
// Shared memory: Q, K, V (Tp, D) bf16; scores S (Tp, Tp) fp32; P (Tp, Tp)
// bf16. Warp w owns rows 16w..16w+15 of S and P; after the softmax its S rows
// are dead and serve as the 16x16 staging tile of its output.

template <int D>
__global__ void __launch_bounds__(MAX_T * 2)
block_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int S, int T, int H, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Tp = pad16(T);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + Tp * D;
  __nv_bfloat16* sV = sK + Tp * D;
  float* sS = reinterpret_cast<float*>(sV + Tp * D);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + Tp * Tp);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = blockIdx.x;
  const int h = (int)(item % H);
  const long long bs = item / H;
  const int s = (int)(bs % S), b = (int)(bs / S);

  load_rows<D>(sQ, seg_base(q, qs, b, s, h, D), qs.t, T, Tp);
  load_rows<D>(sK, seg_base(k, ks, b, s, h, D), ks.t, T, Tp);
  load_rows<D>(sV, seg_base(v, vs, b, s, h, D), vs.t, T, Tp);
  __syncthreads();

  // S = Q K^T for this warp's 16 query rows
  const int i0 = warp * 16;
  float* sS_w = sS + i0 * Tp;
  FragA qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qf[kk], sQ + i0 * D + kk * 16, D);
  for (int n = 0; n < Tp / 16; ++n) {
    FragC sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBt kf;
      wmma::load_matrix_sync(kf, sK + n * 16 * D + kk * 16, D);
      wmma::mma_sync(sf, qf[kk], kf, sf);
    }
    wmma::store_matrix_sync(sS_w + n * 16, sf, Tp, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax: lanes 2r and 2r+1 share row r, half of the columns each;
  // padded key columns (j >= T) get probability 0
  const int r = lane >> 1, half = lane & 1, hw = Tp / 2;
  const float* srow = sS_w + r * Tp + half * hw;
  float mx = NEG_BIG;
  for (int j = 0; j < hw; ++j) {
    if (half * hw + j < T) mx = fmaxf(mx, srow[j] * scale_log2);
  }
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
  __nv_bfloat16* prow = sP + (i0 + r) * Tp + half * hw;
  float l = 0.f;
  for (int j = 0; j < hw; ++j) {
    const float p = half * hw + j < T ? exp2f(srow[j] * scale_log2 - mx) : 0.f;
    l += p;
    prow[j] = __float2bfloat16(p);
  }
  l += __shfl_xor_sync(FULL, l, 1);
  __syncwarp();  // P complete; the warp's score rows are free

  // O = P V / l, 16 output columns at a time
  float* tile = sS_w;
  const float inv = 1.f / l;
  __nv_bfloat16* ob = seg_base(o, os, b, s, h, D);
  for (int n = 0; n < D / 16; ++n) {
    FragC of;
    wmma::fill_fragment(of, 0.f);
    for (int kk = 0; kk < Tp / 16; ++kk) {
      FragA pf;
      FragB vf;
      wmma::load_matrix_sync(pf, sP + i0 * Tp + kk * 16, Tp);
      wmma::load_matrix_sync(vf, sV + kk * 16 * D + n * 16, D);
      wmma::mma_sync(of, pf, vf, of);
    }
    wmma::store_matrix_sync(tile, of, 16, wmma::mem_row_major);
    __syncwarp();
    store_tile(ob + n * 16, os.t, tile, i0, T, inv);
    __syncwarp();
  }
  if (half == 0 && i0 + r < T)
    lse[(((long long)b * H + h) * S + s) * T + i0 + r] = (mx + log2f(l)) * LN2;
}

// ----------------------------------------------------------------- backward
//
// Per segment, from the forward's lse (natural log) and O:
//   P = exp(Q K^T·scale − lse), Δ_i = dO_i·O_i, dV = P^T dO,
//   dS = P∘(dO V^T − Δ), dQ = dS K·scale, dK = dS^T Q·scale.
// As in the Pallas kernel, P and dS are rounded to bf16 before their
// products; everything else is fp32 until the bf16 gradients are written.
//
// Phase 1: warp w forms rows 16w.. of P and dS (bf16, shared) one 16x16 tile
// at a time through two fp32 staging tiles (S, then dO V^T). Phase 2: warp w
// owns key rows 16w.. of dK and dV and query rows 16w.. of dQ, reading P and
// dS transposed (col-major fragments) or not. Each gradient row is written
// by exactly one warp: no atomics, the same result every run.

template <int D>
__global__ void __launch_bounds__(MAX_T * 2)
block_attn_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int T, int H, Strides qs,
                      Strides ks, Strides vs, Strides os, Strides gs, Strides dqs, Strides dks,
                      Strides dvs, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Tp = pad16(T);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + Tp * D;
  __nv_bfloat16* sV = sK + Tp * D;
  __nv_bfloat16* sG = sV + Tp * D;  // dO
  __nv_bfloat16* sP = sG + Tp * D;
  __nv_bfloat16* sD = sP + Tp * Tp;  // dS
  float* sStage = reinterpret_cast<float*>(sD + Tp * Tp);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = blockIdx.x;
  const int h = (int)(item % H);
  const long long bs = item / H;
  const int s = (int)(bs % S), b = (int)(bs / S);

  load_rows<D>(sQ, seg_base(q, qs, b, s, h, D), qs.t, T, Tp);
  load_rows<D>(sK, seg_base(k, ks, b, s, h, D), ks.t, T, Tp);
  load_rows<D>(sV, seg_base(v, vs, b, s, h, D), vs.t, T, Tp);
  load_rows<D>(sG, seg_base(dout, gs, b, s, h, D), gs.t, T, Tp);
  __syncthreads();

  // row statistics of row i (lanes 2r, 2r+1): lse in log2 units, and
  // Δ_i = dO_i·O_i with O read once from device memory
  const int i0 = warp * 16, r = lane >> 1, half = lane & 1, i = i0 + r;
  float lse2 = 0.f, delta = 0.f;
  if (i < T) {
    lse2 = lse[(((long long)b * H + h) * S + s) * T + i] * LOG2E;
    const uint32_t* orow = reinterpret_cast<const uint32_t*>(
        seg_base(o, os, b, s, h, D) + i * os.t + half * (D / 2));
    const uint32_t* grow = reinterpret_cast<const uint32_t*>(sG + i * D + half * (D / 2));
    for (int w = 0; w < D / 4; ++w) {
      const float2 a = unpack(orow[w]), g = unpack(grow[w]);
      delta = fmaf(a.x, g.x, fmaf(a.y, g.y, delta));
    }
  }
  delta += __shfl_xor_sync(FULL, delta, 1);

  float* st0 = sStage + warp * 512;  // S tile, then the output staging tile
  float* st1 = st0 + 256;            // dO V^T tile
  FragA qf[D / 16], gf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + i0 * D + kk * 16, D);
    wmma::load_matrix_sync(gf[kk], sG + i0 * D + kk * 16, D);
  }
  for (int n = 0; n < Tp / 16; ++n) {
    FragC sf, dpf;
    wmma::fill_fragment(sf, 0.f);
    wmma::fill_fragment(dpf, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBt kf, vf;
      wmma::load_matrix_sync(kf, sK + n * 16 * D + kk * 16, D);
      wmma::mma_sync(sf, qf[kk], kf, sf);
      wmma::load_matrix_sync(vf, sV + n * 16 * D + kk * 16, D);
      wmma::mma_sync(dpf, gf[kk], vf, dpf);
    }
    wmma::store_matrix_sync(st0, sf, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(st1, dpf, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = half * 8 + e, j = n * 16 + c;
      float p = 0.f, ds = 0.f;
      if (i < T && j < T) {
        p = exp2f(st0[r * 16 + c] * scale_log2 - lse2);
        ds = p * (st1[r * 16 + c] - delta);
      }
      sP[i * Tp + j] = __float2bfloat16(p);
      sD[i * Tp + j] = __float2bfloat16(ds);
    }
    __syncwarp();
  }
  __syncthreads();  // every warp's rows of P and dS are in place

  const int j0 = warp * 16;
  __nv_bfloat16* dqb = seg_base(dq, dqs, b, s, h, D);
  __nv_bfloat16* dkb = seg_base(dk, dks, b, s, h, D);
  __nv_bfloat16* dvb = seg_base(dv, dvs, b, s, h, D);
  for (int n = 0; n < D / 16; ++n) {
    FragC av, ak, aq;
    wmma::fill_fragment(av, 0.f);
    wmma::fill_fragment(ak, 0.f);
    wmma::fill_fragment(aq, 0.f);
    for (int t = 0; t < Tp / 16; ++t) {
      FragAt pt, dst;
      FragA dsf;
      FragB gb, qb, kb;
      // dV_j = Σ_i P_ij dO_i and dK_j = Σ_i dS_ij Q_i (rows j0.. of P^T, dS^T)
      wmma::load_matrix_sync(pt, sP + t * 16 * Tp + j0, Tp);
      wmma::load_matrix_sync(gb, sG + t * 16 * D + n * 16, D);
      wmma::mma_sync(av, pt, gb, av);
      wmma::load_matrix_sync(dst, sD + t * 16 * Tp + j0, Tp);
      wmma::load_matrix_sync(qb, sQ + t * 16 * D + n * 16, D);
      wmma::mma_sync(ak, dst, qb, ak);
      // dQ_i = Σ_j dS_ij K_j (rows i0.. = j0.. of dS)
      wmma::load_matrix_sync(dsf, sD + j0 * Tp + t * 16, Tp);
      wmma::load_matrix_sync(kb, sK + t * 16 * D + n * 16, D);
      wmma::mma_sync(aq, dsf, kb, aq);
    }
    wmma::store_matrix_sync(st0, av, 16, wmma::mem_row_major);
    __syncwarp();
    store_tile(dvb + n * 16, dvs.t, st0, j0, T, 1.f);
    __syncwarp();
    wmma::store_matrix_sync(st0, ak, 16, wmma::mem_row_major);
    __syncwarp();
    store_tile(dkb + n * 16, dks.t, st0, j0, T, scale);
    __syncwarp();
    wmma::store_matrix_sync(st0, aq, 16, wmma::mem_row_major);
    __syncwarp();
    store_tile(dqb + n * 16, dqs.t, st0, j0, T, scale);
    __syncwarp();
  }
}

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int S, int T, int H, const long long* st, float scale,
                       cudaStream_t stream) {
  const int Tp = pad16(T);
  const size_t smem = (size_t)6 * Tp * D + (size_t)6 * Tp * Tp;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * S * H;
  block_attn_fwd_kernel<D><<<(unsigned)items, Tp * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, T, H, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* dq, void* dk, void* dv, int B,
                       int S, int T, int H, const long long* st, float scale,
                       cudaStream_t stream) {
  const int Tp = pad16(T);
  const size_t smem = (size_t)8 * Tp * D + (size_t)4 * Tp * Tp + (size_t)128 * Tp;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * S * H;
  block_attn_bwd_kernel<D><<<(unsigned)items, Tp * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, T, H, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5),
      strides_at(st, 6), strides_at(st, 7), scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, S, T, H, D) bf16 views, head stride D, unit dim stride, every
// (b, s, t) stride a multiple of 8 elements and 16-byte aligned bases.
// strides: 12 element strides (b, s, t) for q, k, v, o in that order. lse is
// written contiguous (B, H, S, T) fp32, in natural-log units.
extern "C" int hi3d_block_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int S, int T, int H, int D,
                                        const long long* strides, float scale, void* stream) {
  if (T < 2 || T > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_fwd<64>(q, k, v, o, lse, B, S, T, H, strides, scale, st);
    case 128: return (int)launch_fwd<128>(q, k, v, o, lse, B, S, T, H, strides, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// strides: 24 element strides (b, s, t) for q, k, v, o, dO, dq, dk, dv in that
// order; lse is the forward's (B, H, S, T) fp32.
extern "C" int hi3d_block_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv, int B, int S, int T,
                                        int H, int D, const long long* strides, float scale,
                                        void* stream) {
  if (T < 2 || T > MAX_T) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_bwd<64>(q, k, v, o, dout, lse, dq, dk, dv, B, S, T, H, strides, scale, st);
    case 128:
      return (int)launch_bwd<128>(q, k, v, o, dout, lse, dq, dk, dv, B, S, T, H, strides, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
