// Spatial flash-attention forward for Hopper (sm_90a): bf16 Q/K/V, fp32
// online-softmax state, bf16 O and natural-log lse out.
//
// Replaces the Pallas kernel hi3d_tpu/ops/flash_attention.py:_fwd
// (_fwd_kernel_vaug / _fwd_kernel): O = softmax(Q K^T * d^-1/2) V, online
// softmax in the exp2 domain. The TPU kernel walks the k-blocks as a
// sequential grid axis with its state in VMEM scratch; here one block owns a
// (b, h, 64-row q tile) and loops over the k tiles itself, with the running
// max / sum in registers and the output accumulator in shared memory.
//
// What bounds it on the H100: at the UNet's shapes (S = 4096/1024 tokens,
// D = 64) attention is compute bound (4*S*D flops per 2*D*2 bytes read per
// token pair). This first version uses WMMA bf16 tensor-core tiles
// (m16n16k16) for Q K^T and P V, synchronous 16-byte tile loads and no
// pipelining; wgmma/TMA and a register-resident accumulator come later.
//
// Inputs are (B, S, H, D) with arbitrary batch/sequence/head strides and a
// unit D stride, so a (B, S, H*D) nn.Linear output goes in without a
// transpose. Ragged S is masked (keys) and bounds-checked (queries). The
// block-diagonal seg_len mask of the Pallas kernel is not needed on the
// stage-1 path and is not implemented.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // query rows per block, 16 per warp
constexpr int BK = 64;   // key rows per tile
constexpr int WARPS = 4;
constexpr float NEG_BIG = -1e30f;  // not -inf: exp2(-inf - -inf) is NaN
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * D + 2 * BK * D) * 2   // Q, K, V tiles (bf16)
         + (size_t)WARPS * 16 * BK * 4         // scores (fp32), per warp
         + (size_t)WARPS * 16 * BK * 2         // probabilities (bf16), per warp
         + (size_t)WARPS * 16 * D * 4;         // output accumulator (fp32), per warp
}

// Copy rows [s0, s0+64) of a (S, D) slice with row stride `ss` into a dense
// (64, D) shared tile; rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ss, int s0, int S) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += WARPS * 32) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    const int s = s0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + (long long)s * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + row * D + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fa_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int Sq, int Sk, int H,
              long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * D;
  __nv_bfloat16* sV = sK + BK * D;
  float* sS = reinterpret_cast<float*>(sV + BK * D);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sS + WARPS * 16 * BK);
  float* sO = reinterpret_cast<float*>(sP + WARPS * 16 * BK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  float* sS_w = sS + warp * 16 * BK;
  __nv_bfloat16* sP_w = sP + warp * 16 * BK;
  float* sO_w = sO + warp * 16 * D;

  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)h * v_sh;

  load_tile<D>(sQ, qb, q_ss, q0, Sq);
  for (int i = lane; i < 16 * D; i += 32) sO_w[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * D + kk * 16, D);

  // lanes 2r and 2r+1 own row r of the warp's 16 rows, 32 columns each
  const int my_row = lane >> 1, half = lane & 1;
  float m_i = NEG_BIG, l_i = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, k_ss, k0, Sk);
    load_tile<D>(sV, vb, v_ss, k0, Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * D + kk * 16, D);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS_w + n * 16, sf, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax; the column walk is rotated by lane so the 32 lanes hit
    // 32 different shared-memory banks
    const float* srow = sS_w + my_row * BK + half * 32;
    float mx = NEG_BIG;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + lane) & 31;
      const float s = (k0 + half * 32 + c < Sk) ? srow[c] * scale_log2 : NEG_BIG;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = exp2f(m_i - m_new);
    __nv_bfloat16* prow = sP_w + my_row * BK + half * 32;
    float rs = 0.f;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = (j + lane) & 31;
      const float s = (k0 + half * 32 + c < Sk) ? srow[c] * scale_log2 : NEG_BIG;
      const float p = exp2f(s - m_new);
      rs += p;
      prow[c] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * alpha + rs;
    m_i = m_new;
    float* orow = sO_w + my_row * D + half * (D / 2);
    for (int j = 0; j < D / 2; ++j) {
      const int c = (j + lane) % (D / 2);
      orow[c] *= alpha;
    }
    __syncwarp();

    // O += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, sO_w + n * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sP_w + kk * 16, BK);
        wmma::load_matrix_sync(vf, sV + kk * 16 * D + n * 16, D);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(sO_w + n * 16, of, D, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int row = q0 + warp * 16 + my_row;
  if (row < Sq) {
    const float inv = 1.f / l_i;
    __nv_bfloat16* og = o + (((long long)b * Sq + row) * H + h) * D + half * (D / 2);
    const float* orow = sO_w + my_row * D + half * (D / 2);
    for (int j = 0; j < D / 2; ++j) og[j] = __float2bfloat16(orow[j] * inv);
    if (half == 0) lse[((long long)b * H + h) * Sq + row] = (m_i + log2f(l_i)) * LN2;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int Sq, int Sk, int H, const long long* st, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the Pallas kernels of hi3d_tpu/ops/flash_attention.py:_bwd
// (_dkv_kernel, _dq_kernel), with Δ = rowsum(dO∘O) computed first as JAX does
// in XLA. Two launches after Δ, as on the TPU, and no atomics, so the result
// is deterministic:
//   (a) one block per (b, h, 64-row k tile) walks the q tiles, recomputes
//       P^T = exp(K Q^T·scale − lse) and accumulates dV += P^T dO and
//       dK += dS^T Q with dS = P∘(dO V^T − Δ);
//   (b) one block per (b, h, 64-row q tile) walks the k tiles and
//       accumulates dQ += dS K.
// P is recomputed from the forward's natural-log lse in the same exp2 domain
// as the forward (lse·log2 e), so both passes see the forward's softmax.
// P and dS are rounded to bf16 for the tensor-core products, as the Pallas
// kernels round them to the input dtype; the dS itself is formed in fp32.
// `scale` enters dQ and dK once, at the final write.
//
// What bounds it on the H100: 3.5× the forward's matrix work (seven products
// per tile pair, four in (a) and three in (b), against the forward's two), so
// tensor-core throughput. Each warp keeps its
// 16 rows of the resident operands (K, V in (a); Q, dO in (b)) and its fp32
// accumulators in WMMA fragments across the whole loop; scores go through a
// per-warp fp32 scratch in shared memory for the elementwise softmax step.
// WMMA m16n16k16 tiles and synchronous loads, like the forward; wgmma/TMA
// pipelining is later work. Ragged S is handled as in the forward: rows past
// S load as zeros, their probabilities are forced to 0, and they are not
// written.

template <int D>
__host__ __device__ constexpr int scratch_cols() { return D > BK ? D : BK; }  // per-warp fp32 scratch width

template <int D>
constexpr size_t bwd_smem_bytes() {
  return (size_t)4 * 64 * D * 2                          // two resident + two streamed tiles
         + (size_t)2 * 64 * 4                            // lse·log2e and Δ of the q tile
         + (size_t)WARPS * 16 * scratch_cols<D>() * 4    // scores / fp32 out staging
         + (size_t)WARPS * 16 * BK * 4                   // dP (fp32)
         + (size_t)WARPS * 2 * 16 * BK * 2;              // P and dS (bf16)
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Write a warp's 16 × D fp32 accumulator rows, times `mul`, as bf16 rows
// row0.. of a (S, H, D) slice at `dst`, staged through the warp's scratch;
// rows ≥ S are dropped.
template <int D>
__device__ __forceinline__ void store_rows(const Acc (&acc)[D / 16], float* scratch,
                                           __nv_bfloat16* dst, int row0, int S, int H,
                                           float mul, int lane) {
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], D, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    if (row0 + r < S)
      dst[(long long)(row0 + r) * H * D + c] = __float2bfloat16(scratch[e] * mul);
  }
}

// Δ[b, h, i] = Σ_d dO[b, i, h, d]·O[b, i, h, d]; one warp per row.
__global__ void __launch_bounds__(WARPS * 32)
fa_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, int B, int Sq, int H, int D,
                    long long o_sb, long long o_ss, long long o_sh,
                    long long d_sb, long long d_ss, long long d_sh) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= (long long)B * H * Sq) return;
  const int i = (int)(row % Sq);
  const int h = (int)((row / Sq) % H);
  const int b = (int)(row / ((long long)Sq * H));
  const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(
      o + b * o_sb + i * o_ss + h * o_sh);
  const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(
      dout + b * d_sb + i * d_ss + h * d_sh);
  float acc = 0.f;
  for (int w = lane; w < D / 2; w += 32) {
    const float2 a = __bfloat1622float2(orow[w]), c = __bfloat1622float2(drow[w]);
    acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;  // row = (b·H + h)·Sq + i
}

// (a): dK and dV for one (b, h, 64-row k tile).
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fa_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  int Sq, int Sk, int H,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long d_sb, long long d_ss, long long d_sh,
                  float scale, float scale_log2) {
  constexpr int SC = scratch_cols<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * D;
  __nv_bfloat16* sQ = sV + BK * D;
  __nv_bfloat16* sG = sQ + BQ * D;  // dO tile
  float* sL = reinterpret_cast<float*>(sG + BQ * D);
  float* sDelta = sL + BQ;
  float* sS = sDelta + BQ;
  float* sdP = sS + WARPS * 16 * SC;
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(sdP + WARPS * 16 * BK);
  __nv_bfloat16* sdS = sP + WARPS * 16 * BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  float* sS_w = sS + warp * 16 * SC;
  float* sdP_w = sdP + warp * 16 * BK;
  __nv_bfloat16* sP_w = sP + warp * 16 * BQ;
  __nv_bfloat16* sdS_w = sdS + warp * 16 * BQ;

  const __nv_bfloat16* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* gb = dout + (long long)b * d_sb + (long long)h * d_sh;
  const float* lse_b = lse + ((long long)b * H + h) * Sq;
  const float* delta_b = delta + ((long long)b * H + h) * Sq;

  load_tile<D>(sK, k + (long long)b * k_sb + (long long)h * k_sh, k_ss, k0, Sk);
  load_tile<D>(sV, v + (long long)b * v_sb + (long long)h * v_sh, v_ss, k0, Sk);
  __syncthreads();

  // this warp's 16 key rows of K and V, as A operands for the whole loop
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> kf[D / 16], vf[D / 16];
  Acc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], sK + warp * 16 * D + kk * 16, D);
    wmma::load_matrix_sync(vf[kk], sV + warp * 16 * D + kk * 16, D);
    wmma::fill_fragment(dk_acc[kk], 0.f);
    wmma::fill_fragment(dv_acc[kk], 0.f);
  }

  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D>(sQ, qb, q_ss, q0, Sq);
    load_tile<D>(sG, gb, d_ss, q0, Sq);
    for (int i = threadIdx.x; i < BQ; i += WARPS * 32) {
      const bool in = q0 + i < Sq;
      sL[i] = in ? lse_b[q0 + i] * LOG2E : 0.f;
      sDelta[i] = in ? delta_b[q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
#pragma unroll
    for (int n = 0; n < BQ / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> qf, gf;
        wmma::load_matrix_sync(qf, sQ + n * 16 * D + kk * 16, D);
        wmma::load_matrix_sync(gf, sG + n * 16 * D + kk * 16, D);
        wmma::mma_sync(sf, kf[kk], qf, sf);
        wmma::mma_sync(pf, vf[kk], gf, pf);
      }
      wmma::store_matrix_sync(sS_w + n * 16, sf, BQ, wmma::mem_row_major);
      wmma::store_matrix_sync(sdP_w + n * 16, pf, BQ, wmma::mem_row_major);
    }
    __syncwarp();

    // P^T and dS^T = P^T∘(dP^T − Δ); column c is query q0 + c
    for (int e = lane; e < 16 * BQ; e += 32) {
      const int c = e % BQ;
      const float p = (q0 + c < Sq) ? exp2f(sS_w[e] * scale_log2 - sL[c]) : 0.f;
      sP_w[e] = __float2bfloat16(p);
      sdS_w[e] = __float2bfloat16(p * (sdP_w[e] - sDelta[c]));
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa, sa;
      wmma::load_matrix_sync(pa, sP_w + kk * 16, BQ);
      wmma::load_matrix_sync(sa, sdS_w + kk * 16, BQ);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> gf, qf;
        wmma::load_matrix_sync(gf, sG + kk * 16 * D + n * 16, D);
        wmma::load_matrix_sync(qf, sQ + kk * 16 * D + n * 16, D);
        wmma::mma_sync(dv_acc[n], pa, gf, dv_acc[n]);
        wmma::mma_sync(dk_acc[n], sa, qf, dk_acc[n]);
      }
    }
  }

  const long long out_base = ((long long)b * Sk) * H * D + (long long)h * D;
  store_rows<D>(dk_acc, sS_w, dk + out_base, k0 + warp * 16, Sk, H, scale, lane);
  store_rows<D>(dv_acc, sS_w, dv + out_base, k0 + warp * 16, Sk, H, 1.f, lane);
}

// (b): dQ for one (b, h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
fa_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long d_sb, long long d_ss, long long d_sh,
                 float scale, float scale_log2) {
  constexpr int SC = scratch_cols<D>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sQ + BQ * D;  // dO tile
  __nv_bfloat16* sK = sG + BQ * D;
  __nv_bfloat16* sV = sK + BK * D;
  float* sL = reinterpret_cast<float*>(sV + BK * D);
  float* sDelta = sL + BQ;
  float* sS = sDelta + BQ;
  float* sdP = sS + WARPS * 16 * SC;
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(sdP + WARPS * 16 * BK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  float* sS_w = sS + warp * 16 * SC;
  float* sdP_w = sdP + warp * 16 * BK;
  __nv_bfloat16* sdS_w = sdS + warp * 16 * BK;

  const __nv_bfloat16* kb = k + (long long)b * k_sb + (long long)h * k_sh;
  const __nv_bfloat16* vb = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* lse_b = lse + ((long long)b * H + h) * Sq;
  const float* delta_b = delta + ((long long)b * H + h) * Sq;

  load_tile<D>(sQ, q + (long long)b * q_sb + (long long)h * q_sh, q_ss, q0, Sq);
  load_tile<D>(sG, dout + (long long)b * d_sb + (long long)h * d_sh, d_ss, q0, Sq);
  for (int i = threadIdx.x; i < BQ; i += WARPS * 32) {
    const bool in = q0 + i < Sq;
    sL[i] = in ? lse_b[q0 + i] * LOG2E : 0.f;
    sDelta[i] = in ? delta_b[q0 + i] : 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16], gf[D / 16];
  Acc dq_acc[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * D + kk * 16, D);
    wmma::load_matrix_sync(gf[kk], sG + warp * 16 * D + kk * 16, D);
    wmma::fill_fragment(dq_acc[kk], 0.f);
  }
  const float* sL_w = sL + warp * 16;
  const float* sDelta_w = sDelta + warp * 16;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, k_ss, k0, Sk);
    load_tile<D>(sV, vb, v_ss, k0, Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 query rows
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf, pf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(pf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kfb, vfb;
        wmma::load_matrix_sync(kfb, sK + n * 16 * D + kk * 16, D);
        wmma::load_matrix_sync(vfb, sV + n * 16 * D + kk * 16, D);
        wmma::mma_sync(sf, qf[kk], kfb, sf);
        wmma::mma_sync(pf, gf[kk], vfb, pf);
      }
      wmma::store_matrix_sync(sS_w + n * 16, sf, BK, wmma::mem_row_major);
      wmma::store_matrix_sync(sdP_w + n * 16, pf, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P∘(dP − Δ); keys past Sk have P = 0
    for (int e = lane; e < 16 * BK; e += 32) {
      const int r = e / BK, c = e % BK;
      const float p = (k0 + c < Sk) ? exp2f(sS_w[e] * scale_log2 - sL_w[r]) : 0.f;
      sdS_w[e] = __float2bfloat16(p * (sdP_w[e] - sDelta_w[r]));
    }
    __syncwarp();

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> sa;
      wmma::load_matrix_sync(sa, sdS_w + kk * 16, BK);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kfb;
        wmma::load_matrix_sync(kfb, sK + kk * 16 * D + n * 16, D);
        wmma::mma_sync(dq_acc[n], sa, kfb, dq_acc[n]);
      }
    }
  }

  const long long out_base = ((long long)b * Sq) * H * D + (long long)h * D;
  store_rows<D>(dq_acc, sS_w, dq + out_base, q0 + warp * 16, Sq, H, scale, lane);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, const long long* st,
                       float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* gp = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  const long long rows = (long long)B * H * Sq;
  fa_bwd_delta_kernel<<<(unsigned)((rows + WARPS - 1) / WARPS), WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), gp, dp, B, Sq, H, D, st[9], st[10], st[11],
      st[12], st[13], st[14]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  fa_bwd_dkv_kernel<D><<<dim3((Sk + BK - 1) / BK, H, B), WARPS * 32, smem, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      Sq, Sk, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12],
      st[13], st[14], scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_kernel<D><<<dim3((Sq + BQ - 1) / BQ, H, B), WARPS * 32, smem, stream>>>(
      qp, kp, vp, gp, lp, dp, static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], scale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// strides: 9 element strides (b, s, h) for q, k, v in that order.
// O is written contiguous (B, Sq, H, D); lse contiguous (B, H, Sq).
extern "C" int hi3d_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int B, int Sq, int Sk,
                                        int H, int D, const long long* strides,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch<64>(q, k, v, o, lse, B, Sq, Sk, H, strides, scale, s);
    case 80: return (int)launch<80>(q, k, v, o, lse, B, Sq, Sk, H, strides, scale, s);
    case 128: return (int)launch<128>(q, k, v, o, lse, B, Sq, Sk, H, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// strides: 15 element strides (b, s, h) for q, k, v, o, dO in that order;
// lse (B, H, Sq) as the forward wrote it; delta is (B, H, Sq) fp32 scratch.
// dq (B, Sq, H, D), dk and dv (B, Sk, H, D) are written contiguous.
extern "C" int hi3d_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B,
                                        int Sq, int Sk, int H, int D,
                                        const long long* strides, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                                 strides, scale, s);
    case 80:
      return (int)launch_bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                                 strides, scale, s);
    case 128:
      return (int)launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                                  strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
