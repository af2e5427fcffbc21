// Frame-axis (temporal) self-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel hi3d_tpu/ops/temporal_attention.py:_nat_fwd
// (_nat_fwd_kernel): for every (batch b, spatial location s, head h) a T x T
// softmax over the frames, read directly from the (B, T, S, C = H*D)
// projection layout with the head at channel offset h*D, and written back in
// the same layout. No lse is kept: each tile holds its tokens' whole
// attention range.
//
// What bounds it on the H100: the work is 4*T*T*D flops per (b, s, h) against
// 4*T*D*2 bytes moved (q, k, v in, o out), about T/2 flops a byte, so the
// kernel is bound by device-memory bandwidth. The design spends nothing it
// does not have to: one warp owns one (b, s, h); each frame row of D bf16 is
// one coalesced 128-byte transaction (lane l moves the bf16 pair 2l, 2l+1);
// q/k/v sit in shared memory with an odd word stride so the score and output
// loops are bank-conflict free; scores, softmax and the P V product are fp32.
// T is a runtime argument up to 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ float2 unpack(uint32_t w) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__host__ __device__ constexpr int row_words() { return D / 2 + 1; }  // odd stride: no bank conflicts

template <int D>
size_t warp_smem_bytes(int T) {
  return (size_t)(3 * T * row_words<D>() + T * (T + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
temporal_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int B, int T, int S, int H,
                     long long q_sb, long long q_st, long long q_ss,
                     long long k_sb, long long k_st, long long k_ss,
                     long long v_sb, long long v_st, long long v_ss,
                     float scale_log2, int L) {
  constexpr int W = row_words<D>();
  constexpr int NW = D / 2;  // bf16 pairs per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem_raw) + warp * (3 * T * W + T * (T + 1));
  uint32_t* sK = sQ + T * W;
  uint32_t* sV = sK + T * W;
  float* sP = reinterpret_cast<float*>(sV + T * W);

  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= (long long)B * S * H) return;  // whole warp leaves; no block barrier follows
  const int h = (int)(item % H);
  const long long bs = item / H;
  const int s = (int)(bs % S);
  const int b = (int)(bs / S);

  const __nv_bfloat16* qb = q + b * q_sb + s * q_ss + (long long)h * D;
  const __nv_bfloat16* kb = k + b * k_sb + s * k_ss + (long long)h * D;
  const __nv_bfloat16* vb = v + b * v_sb + s * v_ss + (long long)h * D;
  for (int t = 0; t < T; ++t) {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(qb + t * q_st);
    const uint32_t* kr = reinterpret_cast<const uint32_t*>(kb + t * k_st);
    const uint32_t* vr = reinterpret_cast<const uint32_t*>(vb + t * v_st);
    for (int w = lane; w < NW; w += 32) {
      sQ[t * W + w] = qr[w];
      sK[t * W + w] = kr[w];
      sV[t * W + w] = vr[w];
    }
  }
  __syncwarp();

  // L lanes share query row i; lane `sub` takes keys sub, sub+L, ... and the
  // sub-th slice of the output dims. L is a power of two and L * Tpad = 32.
  const int i = lane / L, sub = lane % L;
  const bool active = i < T;
  float mx = -1e30f;
  if (active) {
    const uint32_t* qrow = sQ + i * W;
    for (int j = sub; j < T; j += L) {
      const uint32_t* krow = sK + j * W;
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < NW; ++w) {
        const float2 a = unpack(qrow[w]), c = unpack(krow[w]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
      acc *= scale_log2;
      sP[i * (T + 1) + j] = acc;
      mx = fmaxf(mx, acc);
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
  if (active) {
    for (int j = sub; j < T; j += L) {
      const float e = exp2f(sP[i * (T + 1) + j] - mx);
      sP[i * (T + 1) + j] = e;
      sum += e;
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  __syncwarp();  // all probabilities are written; q is no longer read

  if (active) {
    const float inv = 1.f / sum;
    const int wpl = NW / L;
    for (int w = sub * wpl; w < (sub + 1) * wpl; ++w) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j < T; ++j) {
        const float p = sP[i * (T + 1) + j];
        const float2 c = unpack(sV[j * W + w]);
        ax = fmaf(p, c.x, ax);
        ay = fmaf(p, c.y, ay);
      }
      sQ[i * W + w] = pack(ax * inv, ay * inv);  // reuse q's rows for the output
    }
  }
  __syncwarp();

  const long long o_st = (long long)S * H * D;
  __nv_bfloat16* ob = o + (long long)b * T * o_st + ((long long)s * H + h) * D;
  for (int t = 0; t < T; ++t) {
    uint32_t* orow = reinterpret_cast<uint32_t*>(ob + t * o_st);
    for (int w = lane; w < NW; w += 32) orow[w] = sQ[t * W + w];
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int T,
                   int S, int H, const long long* st, float scale, cudaStream_t stream) {
  int tpad = 1;
  while (tpad < T) tpad <<= 1;
  const int L = 32 / tpad;
  const size_t smem = WARPS * warp_smem_bytes<D>(T);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * S * H;
  const unsigned blocks = (unsigned)((items + WARPS - 1) / WARPS);
  temporal_attn_kernel<D><<<blocks, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, T, S, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f, L);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the Pallas kernel hi3d_tpu/ops/temporal_attention.py:_nat_bwd
// (_nat_bwd_kernel). Per (b, s, h), with no saved lse (a warp holds its
// tokens' whole attention range, so the softmax recomputes exactly):
//   P = softmax(Q K^T·scale), dV = P^T dO, Δ_i = dO_i·O_i,
//   dS = P∘(dO V^T − Δ), dQ = dS K·scale, dK = dS^T Q·scale.
// Everything after the bf16 loads is fp32 (the Pallas kernel rounds P and dS
// to bf16 before its products; here they stay fp32, one rounding fewer).
//
// What bounds it on the H100: 5 rows in and 3 out of T·D bf16 each per
// (b, s, h) against ~10·T·T·D flops, so device-memory bandwidth, as in the
// forward. Same shape as the forward: one warp per (b, s, h), coalesced
// 128-byte frame rows, odd-stride shared-memory rows (bank-conflict free), L
// lanes per frame row. The outputs are staged in the rows of inputs that are
// dead by then (dV over V, dQ over O, dK over dO) and written back coalesced.

template <int D>
size_t bwd_warp_smem_bytes(int T) {
  return (size_t)(5 * T * row_words<D>() + 2 * T * (T + 1)) * 4;
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
temporal_attn_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int B, int T, int S, int H,
                         long long q_sb, long long q_st, long long q_ss,
                         long long k_sb, long long k_st, long long k_ss,
                         long long v_sb, long long v_st, long long v_ss,
                         long long o_sb, long long o_st, long long o_ss,
                         long long g_sb, long long g_st, long long g_ss,
                         float scale, float scale_log2, int L) {
  constexpr int W = row_words<D>();
  constexpr int NW = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem_raw) + warp * (5 * T * W + 2 * T * (T + 1));
  uint32_t* sK = sQ + T * W;
  uint32_t* sV = sK + T * W;
  uint32_t* sO = sV + T * W;
  uint32_t* sG = sO + T * W;  // dO
  float* sP = reinterpret_cast<float*>(sG + T * W);
  float* sS = sP + T * (T + 1);  // dS
  const int TP = T + 1;

  const long long item = (long long)blockIdx.x * WARPS + warp;
  if (item >= (long long)B * S * H) return;  // whole warp leaves; no block barrier follows
  const int h = (int)(item % H);
  const long long bs = item / H;
  const int s = (int)(bs % S);
  const int b = (int)(bs / S);

  const long long hd = (long long)h * D;
  const __nv_bfloat16* qb = q + b * q_sb + s * q_ss + hd;
  const __nv_bfloat16* kb = k + b * k_sb + s * k_ss + hd;
  const __nv_bfloat16* vb = v + b * v_sb + s * v_ss + hd;
  const __nv_bfloat16* ob = o + b * o_sb + s * o_ss + hd;
  const __nv_bfloat16* gb = dout + b * g_sb + s * g_ss + hd;
  for (int t = 0; t < T; ++t) {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(qb + t * q_st);
    const uint32_t* kr = reinterpret_cast<const uint32_t*>(kb + t * k_st);
    const uint32_t* vr = reinterpret_cast<const uint32_t*>(vb + t * v_st);
    const uint32_t* orr = reinterpret_cast<const uint32_t*>(ob + t * o_st);
    const uint32_t* gr = reinterpret_cast<const uint32_t*>(gb + t * g_st);
    for (int w = lane; w < NW; w += 32) {
      sQ[t * W + w] = qr[w];
      sK[t * W + w] = kr[w];
      sV[t * W + w] = vr[w];
      sO[t * W + w] = orr[w];
      sG[t * W + w] = gr[w];
    }
  }
  __syncwarp();

  // L lanes share frame row i; lane `sub` takes columns sub, sub+L, ... and
  // the sub-th slice of the head dims. L is a power of two, L * Tpad = 32.
  const int i = lane / L, sub = lane % L;
  const bool active = i < T;
  const int wpl = NW / L;

  // scores (log2 domain), row max, softmax
  float mx = -1e30f;
  if (active) {
    for (int j = sub; j < T; j += L) {
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < NW; ++w) {
        const float2 a = unpack(sQ[i * W + w]), c = unpack(sK[j * W + w]);
        acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
      }
      acc *= scale_log2;
      sP[i * TP + j] = acc;
      mx = fmaxf(mx, acc);
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
  if (active) {
    for (int j = sub; j < T; j += L) {
      const float e = exp2f(sP[i * TP + j] - mx);
      sP[i * TP + j] = e;
      sum += e;
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  // Δ_i = dO_i·O_i, each of the L lanes of row i taking its slice of dims
  float delta = 0.f;
  if (active) {
    const float inv = 1.f / sum;
    for (int j = sub; j < T; j += L) sP[i * TP + j] *= inv;
    for (int w = sub * wpl; w < (sub + 1) * wpl; ++w) {
      const float2 a = unpack(sG[i * W + w]), c = unpack(sO[i * W + w]);
      delta = fmaf(a.x, c.x, fmaf(a.y, c.y, delta));
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);

  // dS_ij = P_ij (dO_i·V_j − Δ_i)
  if (active) {
    for (int j = sub; j < T; j += L) {
      float acc = 0.f;
#pragma unroll 8
      for (int w = 0; w < NW; ++w) {
        const float2 a = unpack(sG[i * W + w]), c = unpack(sV[j * W + w]);
        acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
      }
      sS[i * TP + j] = sP[i * TP + j] * (acc - delta);
    }
  }
  __syncwarp();  // P and dS complete; V and O are dead

  // lane group r now owns output row r: dV_r = Σ_i P_ir dO_i → over V's row r,
  // dQ_r = scale Σ_j dS_rj K_j → over O's row r
  const int r = i;
  if (active) {
    for (int w = sub * wpl; w < (sub + 1) * wpl; ++w) {
      float vx = 0.f, vy = 0.f, qx = 0.f, qy = 0.f;
      for (int j = 0; j < T; ++j) {
        const float p = sP[j * TP + r], ds = sS[r * TP + j];
        const float2 g = unpack(sG[j * W + w]), kk = unpack(sK[j * W + w]);
        vx = fmaf(p, g.x, vx);
        vy = fmaf(p, g.y, vy);
        qx = fmaf(ds, kk.x, qx);
        qy = fmaf(ds, kk.y, qy);
      }
      sV[r * W + w] = pack(vx, vy);
      sO[r * W + w] = pack(qx * scale, qy * scale);
    }
  }
  __syncwarp();  // dO is dead
  // dK_r = scale Σ_i dS_ir Q_i → over dO's row r
  if (active) {
    for (int w = sub * wpl; w < (sub + 1) * wpl; ++w) {
      float kx = 0.f, ky = 0.f;
      for (int j = 0; j < T; ++j) {
        const float ds = sS[j * TP + r];
        const float2 a = unpack(sQ[j * W + w]);
        kx = fmaf(ds, a.x, kx);
        ky = fmaf(ds, a.y, ky);
      }
      sG[r * W + w] = pack(kx * scale, ky * scale);
    }
  }
  __syncwarp();

  const long long out_st = (long long)S * H * D;
  const long long base = (long long)b * T * out_st + ((long long)s * H + h) * D;
  for (int t = 0; t < T; ++t) {
    uint32_t* qrow = reinterpret_cast<uint32_t*>(dq + base + t * out_st);
    uint32_t* krow = reinterpret_cast<uint32_t*>(dk + base + t * out_st);
    uint32_t* vrow = reinterpret_cast<uint32_t*>(dv + base + t * out_st);
    for (int w = lane; w < NW; w += 32) {
      qrow[w] = sO[t * W + w];
      krow[w] = sG[t * W + w];
      vrow[w] = sV[t * W + w];
    }
  }
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, int B, int T, int S,
                       int H, const long long* st, float scale, cudaStream_t stream) {
  int tpad = 1;
  while (tpad < T) tpad <<= 1;
  const int L = 32 / tpad;
  const size_t smem = WARPS * bwd_warp_smem_bytes<D>(T);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * S * H;
  const unsigned blocks = (unsigned)((items + WARPS - 1) / WARPS);
  temporal_attn_bwd_kernel<D><<<blocks, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, T, S, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], scale, scale * 1.4426950408889634f, L);
  return cudaGetLastError();
}

}  // namespace

// strides: 15 element strides (b, t, s) for q, k, v, o, dO in that order; the
// head and head-dim strides are D and 1. dq, dk, dv are written contiguous
// (B, T, S, H, D).
extern "C" int hi3d_temporal_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, void* dq,
                                           void* dk, void* dv, int B, int T, int S, int H,
                                           int D, const long long* strides, float scale,
                                           void* stream) {
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_bwd<64>(q, k, v, o, dout, dq, dk, dv, B, T, S, H, strides, scale, s);
    case 128: return (int)launch_bwd<128>(q, k, v, o, dout, dq, dk, dv, B, T, S, H, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// strides: 9 element strides (b, t, s) for q, k, v in that order; the head
// and head-dim strides are D and 1. O is written contiguous (B, T, S, H, D).
extern "C" int hi3d_temporal_attention_fwd(const void* q, const void* k, const void* v,
                                           void* o, int B, int T, int S, int H, int D,
                                           const long long* strides, float scale,
                                           void* stream) {
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch<64>(q, k, v, o, B, T, S, H, strides, scale, s);
    case 128: return (int)launch<128>(q, k, v, o, B, T, S, H, strides, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
