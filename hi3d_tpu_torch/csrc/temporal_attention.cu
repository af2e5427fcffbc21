// Frame-axis (temporal) self-attention for clips of up to 32 frames, forward
// (K2) and backward (#5), for Hopper (sm_90a).
//
// K2 replaces the Pallas kernel hi3d_tpu/ops/temporal_attention.py:_nat_fwd
// (_nat_fwd_kernel): for every (batch b, spatial location s, head h) a T x T
// softmax over the frames, read directly from the (B, T, S, C = H*D)
// projection layout with the head at channel offset h*D, and written back in
// the same layout. No lse is kept: each tile holds its tokens' whole
// attention range. As in the Pallas kernel, scores and the softmax are fp32,
// l sums the fp32 probabilities, P is rounded to bf16 for P·V, and O = acc/l.
//
// What bounds it on the H100: per (b, s, h) 4·T·T·D flops against 4·T·D bf16
// moved (q, k, v in, o out), about T/2 flops a byte (8 at T = 16), so
// device-memory bandwidth. K2 is #6's forward (block_attention.cu)
// specialised to one key block of TP = 16 or 32 padded frames, with the same
// building blocks (warp_mma.cuh):
// - Work item: G adjacent segments (flat index u = (b·S + s)·H + h), so the
//   G segments' rows at one frame are one contiguous run of G·D bf16 of the
//   projection. G fills a ring stage of about K2_STAGE_BYTES: 8 segments at
//   T ≤ 16, D = 64 (a stage of 48 KB, two blocks an SM).
// - Loads: 16-byte cp.async copies into a two-stage ring holding the item's
//   Q, K and V (swizzled, zero-filled past T and past the last segment);
//   thread t copies one 16-byte column of one segment at every few rows, so
//   it decodes its segment once an item. A persistent grid (occupancy query)
//   walks the items, the next item's copies in flight while the block
//   computes on this one.
// - One warp owns a 16-row query tile of one segment: S = Q·Kᵀ and O = P·V on
//   tensor cores (mma.sync.m16n8k16, operands by ldmatrix from the swizzled
//   tiles), the scores in registers, padded keys (j ≥ T) at probability 0. No
//   online rescale: the one key block holds every key.
// - Epilogue: O·(1/l) through the warp's own Q rows in shared memory, out as
//   16-byte coalesced row stores into a contiguous (B, T, S, H, D) O.
// The (b, t, s) strides of q, k and v must be multiples of 8 elements on
// 16-byte aligned bases (16-byte copies), as the UNet's projections are.

#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace {

constexpr int K2_WARPS = 8;                 // warps a block, at most
constexpr int K2_STAGE_BYTES = 48 * 1024;   // the bytes a ring stage aims at

struct FrameStrides {  // element strides of a (B, T, S, H, D) view along b, t, s
  long long b, t, s;
};

// The copies of one item's Q, K and V into `stage` ([Q|K|V][G][TP][D],
// swizzled). Thread t takes 16-byte column t % CH of segment t / CH % G at
// rows t / (CH·G), + step, ...: blockDim.x is a multiple of CH·G.
template <int D, int TP>
__device__ __forceinline__ void k2_issue(__nv_bfloat16* stage, const __nv_bfloat16* q,
                                         const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         FrameStrides qs, FrameStrides ks, FrameStrides vs,
                                         int S, int T, int H, int G, int nseg, int item) {
  constexpr int CH = D / 8;
  const int c = threadIdx.x % CH;
  const int g = threadIdx.x / CH % G;
  const int step = blockDim.x / (CH * G);
  const int u = item * G + g;
  const bool live = u < nseg;
  int b = 0, s = 0, h = 0;
  if (live) {
    h = u % H;
    s = u / H % S;
    b = u / H / S;
  }
  const __nv_bfloat16* src[3] = {q + b * qs.b + s * qs.s + (long long)h * D + c * 8,
                                 k + b * ks.b + s * ks.s + (long long)h * D + c * 8,
                                 v + b * vs.b + s * vs.s + (long long)h * D + c * 8};
  const long long st[3] = {qs.t, ks.t, vs.t};
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    __nv_bfloat16* dst = stage + (x * G + g) * TP * D;
    for (int r = threadIdx.x / (CH * G); r < TP; r += step) {
      const bool ok = live && r < T;
      cp_async16(smem_u32(dst + swz<D>(r, c)), ok ? src[x] + r * st[x] : q, ok);
    }
  }
}

template <int D, int TP>
__global__ void __launch_bounds__(K2_WARPS * 32)
k2_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int T,
              int H, FrameStrides qs, FrameStrides ks, FrameStrides vs, float scale_log2, int G,
              int nseg, int items) {
  constexpr int QT = TP / 16;  // query tiles a segment
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int stage_elems = 3 * G * TP * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_g = warp / QT, my_t = warp % QT;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row and column pair

  int item = blockIdx.x, slot = 0;
  if (item < items) k2_issue<D, TP>(ring, q, k, v, qs, ks, vs, S, T, H, G, nseg, item);
  cp_async_commit();
  while (item < items) {
    const int next = item + gridDim.x;
    if (next < items)
      k2_issue<D, TP>(ring + (slot ^ 1) * stage_elems, q, k, v, qs, ks, vs, S, T, H, G, nseg,
                      next);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this stage's copies, from every thread, have landed

    const int u = item * G + my_g;
    if (u < nseg) {
      __nv_bfloat16* stage = ring + slot * stage_elems;
      __nv_bfloat16* sq = stage + (my_g * TP + my_t * 16) * D;  // this warp's 16 Q rows
      const __nv_bfloat16* sk = stage + (G + my_g) * TP * D;
      const __nv_bfloat16* sv = stage + (2 * G + my_g) * TP * D;
      uint32_t qf[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(smem_u32(sq + swz<D>(lane & 15, 2 * kk + (lane >> 4))), qf[kk]);

      // S = Q Kᵀ in the exp2 domain, padded keys masked
      float sacc[TP / 8][4];
#pragma unroll
      for (int n = 0; n < TP / 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < TP / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(smem_u32(sk + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kk + ((lane >> 3) & 1))),
                  bf);
          mma16816(sacc[2 * np], qf[kk], bf[0], bf[1]);
          mma16816(sacc[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }
      float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int n = 0; n < TP / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * tq + (e & 1);
          const float sv2 = j < T ? sacc[n][e] * scale_log2 : NEG_BIG;
          sacc[n][e] = sv2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv2);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      }
      // P = exp2(S − m): fp32 into l, bf16 A fragments straight from the
      // accumulators into O = P V
      float lrow[2] = {0.f, 0.f};
      float oacc[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
#pragma unroll
      for (int ks2 = 0; ks2 < TP / 16; ++ks2) {
        float pr[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pr[h2][e] = exp2f(sacc[2 * ks2 + h2][e] - mx[e >> 1]);
            lrow[e >> 1] += pr[h2][e];
          }
        }
        const uint32_t a[4] = {pack(pr[0][0], pr[0][1]), pack(pr[0][2], pr[0][3]),
                               pack(pr[1][0], pr[1][1]), pack(pr[1][2], pr[1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          ldsm_x4_trans(smem_u32(sv + swz<D>(ks2 * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                             2 * dp + (lane >> 4))),
                        bf);
          mma16816(oacc[2 * dp], a, bf[0], bf[1]);
          mma16816(oacc[2 * dp + 1], a, bf[2], bf[3]);
        }
      }

      // epilogue: O / l through this warp's Q rows, then 16-byte row stores
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lrow[i] += __shfl_xor_sync(FULL, lrow[i], 1);
        lrow[i] += __shfl_xor_sync(FULL, lrow[i], 2);
        inv[i] = 1.f / lrow[i];
      }
      __syncwarp();  // every lane's Q fragments have been read
      uint32_t* stage32 = reinterpret_cast<uint32_t*>(sq);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        stage32[(swz<D>(gr, n) + 2 * tq) >> 1] = pack(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
        stage32[(swz<D>(gr + 8, n) + 2 * tq) >> 1] = pack(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
      }
      __syncwarp();
      const int h = u % H, s = u / H % S, b = u / H / S;
      const long long o_st = (long long)S * H * D;
      __nv_bfloat16* ob = o + (long long)b * T * o_st + ((long long)s * H + h) * D;
      const int t0 = my_t * 16;
      for (int e = lane; e < 16 * CH; e += 32) {
        const int r = e / CH, c = e % CH;
        if (t0 + r < T)
          *reinterpret_cast<uint4*>(ob + (t0 + r) * o_st + c * 8) =
              *reinterpret_cast<const uint4*>(sq + swz<D>(r, c));
      }
    }
    __syncthreads();  // this stage is free for the copies issued next round
    item = next;
    slot ^= 1;
  }
}

template <int D, int TP>
cudaError_t launch_k2(const void* q, const void* k, const void* v, void* o, int B, int T, int S,
                      int H, const long long* st, float scale, cudaStream_t stream) {
  constexpr int QT = TP / 16;
  const int seg_bytes = 3 * TP * D * 2;
  const int G = std::max(1, std::min(K2_WARPS / QT, K2_STAGE_BYTES / seg_bytes));
  const long long nseg = (long long)B * S * H;
  if (nseg >= (1ll << 31)) return cudaErrorInvalidValue;
  const int items = (int)((nseg + G - 1) / G);
  const int threads = G * QT * 32;
  const int smem = 2 * G * seg_bytes;
  // the block's shape is fixed by <D, TP>: opt in to its shared memory and
  // ask for its occupancy once (a per-call query costs tens of µs of host time)
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(k2_fwd_kernel<D, TP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k2_fwd_kernel<D, TP>, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    per_sm = blocks;
  }
  const int grid = std::min(items, per_sm * sm_count());
  k2_fwd_kernel<D, TP><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T, H,
      FrameStrides{st[0], st[1], st[2]}, FrameStrides{st[3], st[4], st[5]},
      FrameStrides{st[6], st[7], st[8]}, scale * LOG2E, G, (int)nseg, items);
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
// forward. Its design is still the first one (a redesign is queued): one warp
// per (b, s, h), coalesced 128-byte frame rows, odd-stride shared-memory rows
// (bank-conflict free), L lanes per frame row, fp32 FMA loops. The outputs
// are staged in the rows of inputs that are dead by then (dV over V, dQ over
// O, dK over dO) and written back coalesced. Its (b, t, s) strides need only
// be even (4-byte bf16 pairs).

constexpr int WARPS = 4;

template <int D>
__host__ __device__ constexpr int row_words() { return D / 2 + 1; }  // odd stride: no bank conflicts

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
      st[12], st[13], st[14], scale, scale * LOG2E, L);
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

// strides: 9 element strides (b, t, s) for q, k, v in that order, each a
// multiple of 8 on 16-byte aligned bases; the head and head-dim strides are D
// and 1. O is written contiguous (B, T, S, H, D). 1 ≤ T ≤ 32.
extern "C" int hi3d_temporal_attention_fwd(const void* q, const void* k, const void* v,
                                           void* o, int B, int T, int S, int H, int D,
                                           const long long* strides, float scale,
                                           void* stream) {
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one_tile = T <= 16;
  switch (D) {
    case 64:
      return (int)(one_tile ? launch_k2<64, 16>(q, k, v, o, B, T, S, H, strides, scale, s)
                            : launch_k2<64, 32>(q, k, v, o, B, T, S, H, strides, scale, s));
    case 128:
      return (int)(one_tile ? launch_k2<128, 16>(q, k, v, o, B, T, S, H, strides, scale, s)
                            : launch_k2<128, 32>(q, k, v, o, B, T, S, H, strides, scale, s));
    default: return (int)cudaErrorInvalidValue;
  }
}
