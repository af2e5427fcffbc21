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
//
// #5 (below) is K2's backward, built the same way; its notes are there.

#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace {

constexpr int K2_WARPS = 8;                 // warps a block, at most
constexpr int K2_STAGE_BYTES = 48 * 1024;   // the bytes a ring stage aims at

struct FrameStrides {  // element strides of a (B, T, S, H, D) view along b, t, s
  long long b, t, s;
};

template <int NT>
struct FrameIn {  // the NT inputs of a kernel and their strides, in stage order
  const __nv_bfloat16* p[NT];
  FrameStrides st[NT];
};

// The copies of one item's NT input tiles into `stage` ([NT][G][TP][D],
// swizzled). Thread t takes 16-byte column t % CH of segment t / CH % G at
// rows t / (CH·G), + step, ...: blockDim.x is a multiple of CH·G.
template <int D, int TP, int NT>
__device__ __forceinline__ void frames_issue(__nv_bfloat16* stage, const FrameIn<NT>& in, int S,
                                             int T, int H, int G, int nseg, int item) {
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
#pragma unroll
  for (int x = 0; x < NT; ++x) {
    const __nv_bfloat16* src = in.p[x] + b * in.st[x].b + s * in.st[x].s + (long long)h * D + c * 8;
    __nv_bfloat16* dst = stage + (x * G + g) * TP * D;
    for (int r = threadIdx.x / (CH * G); r < TP; r += step) {
      const bool ok = live && r < T;
      cp_async16(smem_u32(dst + swz<D>(r, c)), ok ? src + r * in.st[x].t : in.p[0], ok);
    }
  }
}

// A warp's 16×D fp32 tile (rows gr and gr + 8 of D/8 column tiles of 8),
// rows scaled by m0 and m1, as bf16 through 16 swizzled rows `stg` of shared
// memory that only this warp uses, then out as 16-byte row stores to rows
// t0 + r < T of `dst` (row stride `ld` elements).
template <int D>
__device__ __forceinline__ void tile_store(__nv_bfloat16* stg, const float (&acc)[D / 8][4],
                                           float m0, float m1, __nv_bfloat16* dst, long long ld,
                                           int t0, int T) {
  constexpr int CH = D / 8;
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  __syncwarp();  // every lane is done reading these rows
  uint32_t* stg32 = reinterpret_cast<uint32_t*>(stg);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    stg32[(swz<D>(gr, n) + 2 * tq) >> 1] = pack(acc[n][0] * m0, acc[n][1] * m0);
    stg32[(swz<D>(gr + 8, n) + 2 * tq) >> 1] = pack(acc[n][2] * m1, acc[n][3] * m1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    if (t0 + r < T)
      *reinterpret_cast<uint4*>(dst + (t0 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(stg + swz<D>(r, c));
  }
}

// The opt-in to a kernel's shared memory and its blocks an SM, asked once per
// kernel (a per-call query costs tens of µs of host time): each caller holds
// a static `per_sm`, one per instantiation, since the block's shape is fixed
// by its template arguments.
template <typename Kernel>
cudaError_t blocks_per_sm(int& per_sm, Kernel kernel, int threads, int smem) {
  if (per_sm > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  per_sm = blocks;
  return cudaSuccess;
}

template <int D, int TP>
__global__ void __launch_bounds__(K2_WARPS * 32)
k2_fwd_kernel(FrameIn<3> in, __nv_bfloat16* __restrict__ o, int S, int T, int H,
              float scale_log2, int G, int nseg, int items) {
  constexpr int QT = TP / 16;  // query tiles a segment
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int stage_elems = 3 * G * TP * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_g = warp / QT, my_t = warp % QT;
  const int tq = lane & 3;  // fragment column pair

  int item = blockIdx.x, slot = 0;
  if (item < items) frames_issue<D, TP, 3>(ring, in, S, T, H, G, nseg, item);
  cp_async_commit();
  while (item < items) {
    const int next = item + gridDim.x;
    if (next < items) frames_issue<D, TP, 3>(ring + (slot ^ 1) * stage_elems, in, S, T, H, G, nseg, next);
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
      const int h = u % H, s = u / H % S, b = u / H / S;
      const long long o_st = (long long)S * H * D;
      tile_store<D>(sq, oacc, inv[0], inv[1],
                    o + (long long)b * T * o_st + ((long long)s * H + h) * D, o_st, my_t * 16, T);
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
  static int per_sm = 0;
  cudaError_t err = blocks_per_sm(per_sm, k2_fwd_kernel<D, TP>, threads, smem);
  if (err != cudaSuccess) return err;
  FrameIn<3> in;
  const void* ptrs[3] = {q, k, v};
  for (int x = 0; x < 3; ++x) {
    in.p[x] = static_cast<const __nv_bfloat16*>(ptrs[x]);
    in.st[x] = FrameStrides{st[3 * x], st[3 * x + 1], st[3 * x + 2]};
  }
  const int grid = std::min(items, per_sm * sm_count());
  k2_fwd_kernel<D, TP><<<(unsigned)grid, threads, smem, stream>>>(
      in, static_cast<__nv_bfloat16*>(o), S, T, H, scale * LOG2E, G, (int)nseg, items);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// #5 replaces the Pallas kernel hi3d_tpu/ops/temporal_attention.py:_nat_bwd
// (_nat_bwd_kernel). Per (b, s, h), with no saved lse (the tile holds its
// tokens' whole attention range, so the softmax recomputes exactly):
//   P = softmax(Q Kᵀ·scale), Δ_i = dO_i·O_i, dS = P∘(dO Vᵀ − Δ),
//   dV = Pᵀ dO, dQ = dS K·scale, dK = dSᵀ Q·scale.
// Scores, the softmax, Δ and dS are fp32; as in the Pallas kernel, P and dS
// are rounded to bf16 before their products. At T = 1 the one probability
// is 1 and dS is 0 exactly (dS is set to 0 there: the two sums of dO·V that
// dP and Δ take would leave a few ulps), so dV = dO and dQ = dK = 0.
//
// What bounds it on the H100: per (b, s, h) about 10·T·T·D flops against
// 8·T·D bf16 moved (Q, K, V, O, dO in; dQ, dK, dV out), about 10 flops a
// byte at T = 16, so device-memory bandwidth: the design is about bytes in
// flight. It is K2's forward turned backward, with #7's split of roles
// (block_attention.cu) specialised to one key block of TP = 16 or 32 frames:
// - Work item: G adjacent segments (as K2); a ring stage holds the item's Q,
//   K, V, dO and O, swizzled, zero-filled past T and past the last segment,
//   by K2's 16-byte cp.async copies. G fills about B5_STAGE_BYTES: 4 segments
//   at T ≤ 16, D = 64 (a 40 KB stage, two blocks an SM). The same two-stage
//   ring and persistent grid as K2: the next item's copies are in flight
//   while the block computes on this one.
// - One warp a 16-row tile of one segment (TP/16 warps a segment). First
//   query-major: S = Q Kᵀ and dP = dO Vᵀ for its 16 queries × all TP keys
//   in registers (mma.sync.m16n8k16, operands by ldmatrix), the row max and
//   sum by quad shuffles, Δ from the stage's dO and O rows (16-byte reads,
//   one shuffle); dS, taken from the accumulator fragments as bf16, is the A
//   operand of dQ = dS K, which the warp sums alone.
// - Then key-major for dV = Pᵀ dO and dK = dSᵀ Q, which need P and dS
//   transposed as the A operand. Each warp writes its rows of the bf16 P and
//   dS to the segment's TP×TP scratch after the ring (512 B each at TP =
//   16), and, after a barrier (a warp's own at TP = 16, the block's at TP =
//   32), the warp of key tile j reads Pᵀ and dSᵀ of its 16 keys back with
//   ldmatrix.trans and sums dV and dK over the query tiles in order. This
//   was chosen over forming Sᵀ and dPᵀ key-major as #7 does: it costs two
//   512-byte writes and two ldmatrix a tile instead of forming S and dP
//   twice (14 flops for 10), and the row statistics never leave the warp.
//   No atomics: each gradient element is summed by one warp in a fixed
//   order, so the result is bitwise the same run to run.
// - Epilogue: each gradient tile is scaled, rounded to bf16 and staged
//   through 16 rows that no other warp reads by then (dQ over the warp's O
//   rows, dV over its key tile's V rows, dK over its K rows), then leaves as
//   16-byte row stores into contiguous (B, T, S, H, D) dq, dk, dv.
// The (b, t, s) strides of all five inputs must be multiples of 8 elements
// on 16-byte aligned bases; the wrapper copies an operand that is not.

constexpr int B5_WARPS = 8;                 // warps a block, at most
constexpr int B5_STAGE_BYTES = 40 * 1024;   // the bytes a ring stage aims at

// Element offset of 16-byte chunk c of row r in a TP×TP bf16 scratch tile:
// chunk c ^ f(r), f cycling over the chunks of a row every 8 / (TP/8) rows,
// so the 8 rows an ldmatrix phase (or a fragment store) touches fall on
// distinct banks.
template <int TP>
__device__ __forceinline__ int swz_pt(int r, int c) {
  constexpr int NC = TP / 8;
  return r * TP + ((c ^ (r / (8 / NC) % NC)) << 3);
}

template <int D, int TP>
__global__ void __launch_bounds__(B5_WARPS * 32)
k2_bwd_kernel(FrameIn<5> in, __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int S, int T, int H, float scale,
              float scale_log2, int G, int nseg, int items) {
  constexpr int QT = TP / 16;  // 16-row tiles a segment
  constexpr int CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tile_elems = G * TP * D;  // one input's tiles of the G segments
  const int stage_elems = 5 * tile_elems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_g = warp / QT, t16 = warp % QT * 16;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row and column pair
  __nv_bfloat16* sP = ring + 2 * stage_elems + my_g * 2 * TP * TP;  // this segment's P, then dS
  __nv_bfloat16* sD = sP + TP * TP;
  const long long ld = (long long)S * H * D;  // frame stride of dq, dk, dv

  int item = blockIdx.x, slot = 0;
  if (item < items) frames_issue<D, TP, 5>(ring, in, S, T, H, G, nseg, item);
  cp_async_commit();
  while (item < items) {
    const int next = item + gridDim.x;
    if (next < items) frames_issue<D, TP, 5>(ring + (slot ^ 1) * stage_elems, in, S, T, H, G, nseg, next);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this stage's copies, from every thread, have landed

    // this segment's tiles in the stage; a segment past the last computes
    // on zeros and stores nothing (every warp reaches the barriers)
    __nv_bfloat16* sQ = ring + slot * stage_elems + my_g * TP * D;
    __nv_bfloat16* sK = sQ + tile_elems;
    __nv_bfloat16* sV = sK + tile_elems;
    const __nv_bfloat16* sG = sV + tile_elems;  // dO
    __nv_bfloat16* sO = sV + 2 * tile_elems;
    const int u = item * G + my_g;
    const bool live = u < nseg;
    long long base = 0;  // element (b, 0, s, h, 0) of the gradients
    if (live) base = (long long)(u / H / S) * T * ld + (long long)(u % (S * H)) * D;

    // Δ of this warp's 16 query rows: lane l takes row l % 16, half l / 16 of D
    float dl = 0.f;
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const int r = t16 + (lane & 15), c = (lane >> 4) * (CH / 2) + i;
      dl += dot8(*reinterpret_cast<const uint4*>(sG + swz<D>(r, c)),
                 *reinterpret_cast<const uint4*>(sO + swz<D>(r, c)));
    }
    dl += __shfl_xor_sync(FULL, dl, 16);
    const float dl0 = __shfl_sync(FULL, dl, gr), dl1 = __shfl_sync(FULL, dl, gr + 8);

    // S = Q Kᵀ and dP = dO Vᵀ: this warp's 16 queries × all TP keys
    float sacc[TP / 8][4], pacc[TP / 8][4];
#pragma unroll
    for (int n = 0; n < TP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      const int ra = t16 + (lane & 15), ca = 2 * kk + (lane >> 4);
      ldsm_x4(smem_u32(sQ + swz<D>(ra, ca)), qa);
      ldsm_x4(smem_u32(sG + swz<D>(ra, ca)), ga);
#pragma unroll
      for (int np = 0; np < TP / 16; ++np) {
        uint32_t kb[4], vb[4];
        const int rb = np * 16 + (lane & 7) + ((lane >> 4) << 3), cb = 2 * kk + ((lane >> 3) & 1);
        ldsm_x4(smem_u32(sK + swz<D>(rb, cb)), kb);
        ldsm_x4(smem_u32(sV + swz<D>(rb, cb)), vb);
        mma16816(sacc[2 * np], qa, kb[0], kb[1]);
        mma16816(sacc[2 * np + 1], qa, kb[2], kb[3]);
        mma16816(pacc[2 * np], ga, vb[0], vb[1]);
        mma16816(pacc[2 * np + 1], ga, vb[2], vb[3]);
      }
    }
    // P = softmax over the T keys in the exp2 domain (padded keys at 0), then
    // dS = P (dP − Δ); both fp32, P into sacc and dS into pacc
    float mx[2] = {NEG_BIG, NEG_BIG}, lrow[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < TP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tq + (e & 1);
        sacc[n][e] = j < T ? sacc[n][e] * scale_log2 : NEG_BIG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
#pragma unroll
    for (int n = 0; n < TP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = exp2f(sacc[n][e] - mx[e >> 1]);
        lrow[e >> 1] += sacc[n][e];
      }
    }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lrow[i] += __shfl_xor_sync(FULL, lrow[i], 1);
      lrow[i] += __shfl_xor_sync(FULL, lrow[i], 2);
      inv[i] = 1.f / lrow[i];
    }
#pragma unroll
    for (int n = 0; n < TP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] *= inv[e >> 1];
        pacc[n][e] = T > 1 ? sacc[n][e] * (pacc[n][e] - (e < 2 ? dl0 : dl1)) : 0.f;
      }
    }

    // dQ = dS K·scale, dS's bf16 A fragments straight from its accumulators
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < TP / 16; ++ks) {
      const uint32_t da[4] = {pack(pacc[2 * ks][0], pacc[2 * ks][1]),
                              pack(pacc[2 * ks][2], pacc[2 * ks][3]),
                              pack(pacc[2 * ks + 1][0], pacc[2 * ks + 1][1]),
                              pack(pacc[2 * ks + 1][2], pacc[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(smem_u32(sK + swz<D>(ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                           2 * dp + (lane >> 4))),
                      b);
        mma16816(acc[2 * dp], da, b[0], b[1]);
        mma16816(acc[2 * dp + 1], da, b[2], b[3]);
      }
    }
    // this warp's rows of P and dS, bf16, into the segment's scratch
    uint32_t* p32 = reinterpret_cast<uint32_t*>(sP);
    uint32_t* d32 = reinterpret_cast<uint32_t*>(sD);
#pragma unroll
    for (int n = 0; n < TP / 8; ++n) {
      const int w0 = (swz_pt<TP>(t16 + gr, n) + 2 * tq) >> 1;
      const int w1 = (swz_pt<TP>(t16 + gr + 8, n) + 2 * tq) >> 1;
      p32[w0] = pack(sacc[n][0], sacc[n][1]);
      p32[w1] = pack(sacc[n][2], sacc[n][3]);
      d32[w0] = pack(pacc[n][0], pacc[n][1]);
      d32[w1] = pack(pacc[n][2], pacc[n][3]);
    }
    // dQ out through this warp's O rows (no other warp reads them)
    if (live) tile_store<D>(sO + t16 * D, acc, scale, scale, dq + base, ld, t16, T);
    // every query tile's P and dS are in place, and no warp reads K or V again
    if (QT > 1)
      __syncthreads();
    else
      __syncwarp();

    // key-major: dV = Pᵀ dO, then dK = dSᵀ Q·scale, for this warp's 16 keys,
    // summed over the query tiles in order; Pᵀ and dSᵀ by ldmatrix.trans
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const __nv_bfloat16* sa = pass ? sD : sP;
      const __nv_bfloat16* sb = pass ? sQ : sG;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int qt = 0; qt < QT; ++qt) {
        uint32_t a[4];
        ldsm_x4_trans(smem_u32(sa + swz_pt<TP>(qt * 16 + (lane & 7) + ((lane >> 4) << 3),
                                               t16 / 8 + ((lane >> 3) & 1))),
                      a);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(smem_u32(sb + swz<D>(qt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                             2 * dp + (lane >> 4))),
                        b);
          mma16816(acc[2 * dp], a, b[0], b[1]);
          mma16816(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
      // out through this key tile's V rows (dV) or K rows (dK)
      const float mul = pass ? scale : 1.f;
      if (live)
        tile_store<D>((pass ? sK : sV) + t16 * D, acc, mul, mul, (pass ? dk : dv) + base, ld,
                      t16, T);
    }
    __syncthreads();  // this stage and the scratch are free for the next round
    item = next;
    slot ^= 1;
  }
}

template <int D, int TP>
cudaError_t launch_b5(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, void* dq, void* dk, void* dv, int B, int T, int S, int H,
                      const long long* st, float scale, cudaStream_t stream) {
  constexpr int QT = TP / 16;
  const int seg_bytes = 5 * TP * D * 2;
  const int G = std::max(1, std::min(B5_WARPS / QT, B5_STAGE_BYTES / seg_bytes));
  const long long nseg = (long long)B * S * H;
  if (nseg >= (1ll << 31)) return cudaErrorInvalidValue;
  const int items = (int)((nseg + G - 1) / G);
  const int threads = G * QT * 32;
  const int smem = 2 * G * seg_bytes + G * 2 * TP * TP * 2;  // the ring, then P and dS
  static int per_sm = 0;
  cudaError_t err = blocks_per_sm(per_sm, k2_bwd_kernel<D, TP>, threads, smem);
  if (err != cudaSuccess) return err;
  // stage order Q, K, V, dO, O; the strides arrive as q, k, v, o, dO
  FrameIn<5> in;
  const void* ptrs[5] = {q, k, v, dout, o};
  const int at[5] = {0, 1, 2, 4, 3};
  for (int x = 0; x < 5; ++x) {
    in.p[x] = static_cast<const __nv_bfloat16*>(ptrs[x]);
    in.st[x] = FrameStrides{st[3 * at[x]], st[3 * at[x] + 1], st[3 * at[x] + 2]};
  }
  const int grid = std::min(items, per_sm * sm_count());
  k2_bwd_kernel<D, TP><<<(unsigned)grid, threads, smem, stream>>>(
      in, static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, T, H, scale, scale * LOG2E, G, (int)nseg, items);
  return cudaGetLastError();
}

}  // namespace

// strides: 15 element strides (b, t, s) for q, k, v, o, dO in that order, each
// a multiple of 8 on 16-byte aligned bases; the head and head-dim strides are
// D and 1. dq, dk, dv are written contiguous (B, T, S, H, D). 1 ≤ T ≤ 32.
extern "C" int hi3d_temporal_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, void* dq,
                                           void* dk, void* dv, int B, int T, int S, int H,
                                           int D, const long long* strides, float scale,
                                           void* stream) {
  if (T < 1 || T > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one_tile = T <= 16;
  switch (D) {
    case 64:
      return (int)(one_tile ? launch_b5<64, 16>(q, k, v, o, dout, dq, dk, dv, B, T, S, H, strides, scale, s)
                            : launch_b5<64, 32>(q, k, v, o, dout, dq, dk, dv, B, T, S, H, strides, scale, s));
    case 128:
      return (int)(one_tile ? launch_b5<128, 16>(q, k, v, o, dout, dq, dk, dv, B, T, S, H, strides, scale, s)
                            : launch_b5<128, 32>(q, k, v, o, dout, dq, dk, dv, B, T, S, H, strides, scale, s));
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
