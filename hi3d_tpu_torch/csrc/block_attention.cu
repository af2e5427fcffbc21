// Segment-local (block-diagonal) attention, forward and backward, for Hopper
// (sm_90a): frame-axis self-attention over long clips, one segment = the T
// frames of one (batch b, spatial location s, head h).
//
// Replaces the Pallas kernels hi3d_tpu/ops/temporal_attention.py:_fwd3
// (_fwd_kernel) and _bwd3 (_bwd_kernel). The TPU kernels cut the
// location-major token sequence (B·H, S·T, D) into blocks of many segments
// (up to 512 tokens) to keep the 128x128 MXU fed, and mask every score
// outside a query's own segment. Here no score outside a segment is formed.
// The inputs are strided 5-D views (B, S, T, H, D) with the segment along
// axis 2, so the UNet's (B, T, S, H, D) projections go in as transposed views
// with no copy. T is any length from 2; D is 64 or 128.
//
// What bounds it on the H100: per segment 4·T·T·D flops (forward) against
// 4·T·D bf16 moved, about T/2 flops a byte (24 at T = 48), far below the
// card's ~295 on tensor cores, so device-memory bandwidth bounds it: the
// design is about bytes in flight and about the traffic through shared
// memory, not about tensor-core peak.
//
// Forward (#6):
// - Work item: a group of G adjacent segments (flat index u = (b·S + s)·H + h,
//   so for the UNet's projections the G segments' rows at one frame are one
//   contiguous run of G·D bf16) and a chunk of at most 8 query tiles of 16
//   rows. One warp owns one 16-row query tile of one segment of the group;
//   G = max(1, 4 / tiles a chunk), so a block has 1–8 warps (3 at T = 48):
//   small blocks, several to an SM, each with its own copy pipeline. T > 128
//   splits a segment's queries into balanced chunks, each streaming the keys
//   again.
// - Keys in blocks of at most KB = 64 frames, with an online softmax in the
//   exp2 domain (as K1), so any T runs with bounded registers and shared
//   memory; T ≤ 64 is one key block.
// - Loads: 16-byte cp.async copies (zero-filled past T and past the last
//   segment) into a ring of two stages, each holding the item's Q (first key
//   block only) and one key block of K and V for its G segments. While the
//   block computes on one stage the copies of the next (the next key block,
//   or the next item's Q, K and V) are in flight. cp.async rather than TMA:
//   a TMA map would need 16-byte-aligned strides on every axis, narrower than
//   the views the wrapper accepts (8-element (b, s, t) strides), and one path.
// - Persistent grid: as many blocks as fit on the SMs (occupancy query), each
//   walking over items, so an item's epilogue overlaps the next one's loads.
// - Products on tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 out): its
//   16-row tiles fit T that is not a multiple of 64, where wgmma's 64-row M
//   would pad T = 48 and T = 33 to 64; at ~24 flops a byte the kernel needs
//   ~80 TFLOP/s, which mma.sync gives. Operands come from shared memory by
//   ldmatrix (V by ldmatrix.trans); every tile is stored with its 16-byte
//   chunk c of row r at chunk c ^ (r % 8), so the eight rows an ldmatrix
//   phase reads fall on distinct banks. The scores stay in registers: the
//   accumulator fragment of Q·Kᵀ, exponentiated and rounded to bf16, is the A
//   fragment of P·V. Padded key columns (j ≥ T) get probability 0; padded
//   query rows are computed on zeros and never stored.
// - Epilogue: O, scaled by 1/l, goes through the warp's own (swizzled) rows
//   of the stage's Q tile and leaves as 16-byte coalesced row stores; lse is
//   written as fp32 in natural-log units, (B, H, S, T) contiguous, for #7.
//
// Backward (#7): per segment 10·T·T·D flops (14 as computed: S and dP are
// formed twice, once key-major and once query-major) against 8·T·D bf16
// moved (Q, K, V, O, dO in; dQ, dK, dV out), about 0.6·T flops a byte: bytes
// bound it up to T ≈ 470, tensor cores past that.
// - Work item: a group of G adjacent segments (as #6) and one own frame
//   block (BR = 64 frames; see MULTI below). Its warps take two roles over
//   (segment, own 16-row tile, 64-column half of D): a key-major warp sums
//   dK and dV of its key tile, a query-major warp dQ of its query tile. So
//   dQ needs no atomics and no second launch, and each gradient element is
//   summed by one warp in a fixed order: the same result every run.
//   Splitting D in halves keeps a key-major warp at 64 fp32 accumulators at
//   D = 128 as at D = 64.
// - The item streams every frame block of its segments (its own block
//   first) through the same two-stage cp.async ring as #6: a stage holds Q,
//   K, V, dO, O and lse of one block for the G segments, swizzled, zero-
//   filled past T and past the last segment. Δ = rowsum(dO∘O) is formed from
//   the stage's tiles (16-byte shared reads, a shuffle reduction a row) and
//   lse goes to log2 units once, with padded rows at 1e30 so their P is 0.
//   T ≤ 64 is one block: an item reads each input once and both roles read
//   the one stage, while the next item's copies are in flight. Past 64
//   frames (MULTI) the own block is copied out of the ring at the item's
//   first step and the other blocks come again (from L2, the segment's items
//   being neighbours), so any T runs in bounded shared memory; there Δ comes
//   from a pre-pass kernel instead of O, so a stage holds four tiles, and
//   the blocks are 128 frames at D = 64 from 256 frames.
// - mma.sync.m16n8k16 as in #6. A key-major warp forms Sᵀ = K Qᵀ and
//   dPᵀ = V dOᵀ for 16 keys × 16 queries; Pᵀ = exp2(Sᵀ·scale·log2e − lse2)
//   and dSᵀ = Pᵀ∘(dPᵀ − Δ), packed to bf16, are the A fragments of dV += Pᵀ dO
//   and dK += dSᵀ Q (dO and Q by ldmatrix.trans). A query-major warp forms S
//   and dP for 16 queries × 16 keys and dS is the A fragment of dQ += dS K.
//   No P, dS or fp32 tile goes through shared memory.
// - Epilogue: each gradient tile, scaled and rounded to bf16, goes through
//   the warp's own 2 KB of the spent stage and leaves as 16-byte row stores.

#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace {

constexpr int KB = 64;              // forward key block (frames)
constexpr int FWD_WARPS = 8;        // forward warps a block, at most (query tiles a chunk)
constexpr int FWD_GROUP_WARPS = 4;  // forward: segments are grouped up to this many warps
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use
constexpr int FWD_RING_CAP = 113 * 1024;  // two forward blocks to an SM
constexpr float LN2 = 0.6931471805599453f;

struct Strides {  // element strides of a (B, S, T, H, D) view along b, s, t
  long long b, s, t;
};

// The segment's first row: element (b, s, 0, h, 0) of a strided view.
template <typename T>
__device__ __forceinline__ T* seg_base(T* x, const Strides& st, int b, int s, int h, int D) {
  return x + b * st.b + s * st.s + (long long)h * D;
}

// ------------------------------------------------------------------ forward

struct FwdPlan {      // the host's blocking of one launch
  int G;              // segments a work item
  int qt;             // 16-row query tiles a work item, per segment
  int nqc;            // query chunks a segment
  int kr;             // key rows a stage holds: min(KB, Tp)
  int nkb;            // key blocks a segment
  int nseg;           // B·S·H (below 2^31: the launcher checks)
  int items;          // ceil(nseg / G) · nqc
};

// One stage: Q [G][qt·16][D], then K and V [G][kr][D], all swizzled.
template <int D>
__device__ __forceinline__ void fwd_issue(__nv_bfloat16* stage, const __nv_bfloat16* q,
                                          const __nv_bfloat16* k, const __nv_bfloat16* v,
                                          const Strides& qs, const Strides& ks,
                                          const Strides& vs, const FwdPlan& p, int S, int T,
                                          int H, int item, int kb) {
  constexpr int CH = D / 8;
  const int u0 = item / p.nqc * p.G;
  const int qr = p.qt * 16;
  // segment by segment (its (b, s, h) decoded once), 16 bytes a thread,
  // consecutive threads along a row: each row is whole 128-byte lines
  auto region = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, const Strides& st, int row0,
                    int rows) {
    for (int g = 0; g < p.G; ++g) {
      const int u = u0 + g;
      const bool live = u < p.nseg;
      const __nv_bfloat16* sb = src;
      if (live) sb = seg_base(src, st, u / H / S, u / H % S, u % H, D);
      __nv_bfloat16* d = dst + g * rows * D;
      for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
        const int c = e % CH, r = e / CH, t = row0 + r;
        const bool ok = live && t < T;
        cp_async16(smem_u32(d + swz<D>(r, c)), ok ? sb + t * st.t + c * 8 : src, ok);
      }
    }
  };
  if (kb == 0) region(stage, q, qs, item % p.nqc * qr, qr);
  __nv_bfloat16* sk = stage + p.G * qr * D;
  region(sk, k, ks, kb * KB, p.kr);
  region(sk + p.G * p.kr * D, v, vs, kb * KB, p.kr);
}

template <int D>
__global__ void __launch_bounds__(FWD_WARPS * 32)
block_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int S, int T, int H, Strides qs, Strides ks,
                      Strides vs, Strides os, float scale_log2, FwdPlan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int CH = D / 8;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int qr = p.qt * 16;
  const int stage_elems = p.G * (qr + 2 * p.kr) * D;
  const int Tp = pad16(T), mt_total = Tp / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_g = warp / p.qt, my_t = warp % p.qt;
  const int gr = lane >> 2, tq = lane & 3;  // fragment row and column pair

  uint32_t qf[D / 16][4];
  float oacc[D / 8][4];
  float mrow[2], lrow[2];

  int item = blockIdx.x, kb = 0, slot = 0;
  if (item < p.items) fwd_issue<D>(ring, q, k, v, qs, ks, vs, p, S, T, H, item, 0);
  cp_async_commit();
  while (item < p.items) {
    int next = item, next_kb = kb + 1;
    if (next_kb == p.nkb) {
      next_kb = 0;
      next += gridDim.x;
    }
    if (next < p.items)
      fwd_issue<D>(ring + (slot ^ 1) * stage_elems, q, k, v, qs, ks, vs, p, S, T, H, next,
                   next_kb);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this stage's copies, from every thread, have landed

    const int u = item / p.nqc * p.G + my_g;
    const int mtile = item % p.nqc * p.qt + my_t;
    if (u < p.nseg && mtile < mt_total) {
      __nv_bfloat16* stage = ring + slot * stage_elems;
      __nv_bfloat16* sq = stage + (my_g * qr + my_t * 16) * D;  // this warp's 16 Q rows
      const __nv_bfloat16* sk = stage + p.G * qr * D + my_g * p.kr * D;
      const __nv_bfloat16* sv = sk + p.G * p.kr * D;
      if (kb == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(smem_u32(sq + swz<D>(lane & 15, 2 * kk + (lane >> 4))), qf[kk]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
        mrow[0] = mrow[1] = NEG_BIG;
        lrow[0] = lrow[1] = 0.f;
      }
      const int kb0 = kb * KB;
      const int rows = min(p.kr, Tp - kb0);  // a multiple of 16

      // S = Q Kᵀ for this key block, in the exp2 domain; padded keys masked
      float sacc[KB / 8][4];
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < KB / 16; ++np) {
          if (np * 16 < rows) {
            uint32_t b[4];
            ldsm_x4(smem_u32(sk + swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                         2 * kk + ((lane >> 3) & 1))),
                    b);
            mma16816(sacc[2 * np], qf[kk], b[0], b[1]);
            mma16816(sacc[2 * np + 1], qf[kk], b[2], b[3]);
          }
        }
      }
      float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) {
        if (n * 8 < rows) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = kb0 + n * 8 + 2 * tq + (e & 1);
            const float sv2 = j < T ? sacc[n][e] * scale_log2 : NEG_BIG;
            sacc[n][e] = sv2;
            mx[e >> 1] = fmaxf(mx[e >> 1], sv2);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float mnew = fmaxf(mrow[i], mx[i]);
        alpha[i] = exp2f(mrow[i] - mnew);
        mrow[i] = mnew;
        lrow[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        oacc[n][0] *= alpha[0];
        oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1];
        oacc[n][3] *= alpha[1];
      }
      // P = exp2(S − m) (this thread's share of l in fp32), then O += P V
      // with P's bf16 A fragments taken straight from the S accumulators
#pragma unroll
      for (int ks2 = 0; ks2 < KB / 16; ++ks2) {
        if (ks2 * 16 < rows) {
          float pr[2][4];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pr[h2][e] = exp2f(sacc[2 * ks2 + h2][e] - mrow[e >> 1]);
              lrow[e >> 1] += pr[h2][e];
            }
          }
          const uint32_t a[4] = {pack(pr[0][0], pr[0][1]), pack(pr[0][2], pr[0][3]),
                                 pack(pr[1][0], pr[1][1]), pack(pr[1][2], pr[1][3])};
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(smem_u32(sv + swz<D>(ks2 * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * dp + (lane >> 4))),
                          b);
            mma16816(oacc[2 * dp], a, b[0], b[1]);
            mma16816(oacc[2 * dp + 1], a, b[2], b[3]);
          }
        }
      }

      if (kb == p.nkb - 1) {  // epilogue: O / l through this warp's Q rows
        float inv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lrow[i] += __shfl_xor_sync(FULL, lrow[i], 1);
          lrow[i] += __shfl_xor_sync(FULL, lrow[i], 2);
          inv[i] = 1.f / lrow[i];
        }
        __syncwarp();  // every lane's Q fragments were read at kb == 0
        uint32_t* stage32 = reinterpret_cast<uint32_t*>(sq);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          stage32[(swz<D>(gr, n) + 2 * tq) >> 1] = pack(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
          stage32[(swz<D>(gr + 8, n) + 2 * tq) >> 1] =
              pack(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
        }
        __syncwarp();
        const int h = u % H, s = u / H % S, b = u / H / S;
        __nv_bfloat16* ob = seg_base(o, os, b, s, h, D);
        const int t0 = mtile * 16;
        for (int e = lane; e < 16 * CH; e += 32) {
          const int r = e / CH, c = e % CH;
          if (t0 + r < T)
            *reinterpret_cast<uint4*>(ob + (long long)(t0 + r) * os.t + c * 8) =
                *reinterpret_cast<const uint4*>(sq + swz<D>(r, c));
        }
        if (tq == 0) {
          float* lb = lse + (((long long)b * H + h) * S + s) * T + t0;
          if (t0 + gr < T) lb[gr] = (mrow[0] + log2f(lrow[0])) * LN2;
          if (t0 + gr + 8 < T) lb[gr + 8] = (mrow[1] + log2f(lrow[1])) * LN2;
        }
      }
    }
    __syncthreads();  // this stage is free for the copies issued next round
    item = next;
    kb = next_kb;
    slot ^= 1;
  }
}

// ----------------------------------------------------------------- backward
//
// Per segment, from the forward's lse (natural log) and O:
//   P = exp(Q Kᵀ·scale − lse), Δ_i = dO_i·O_i, dV = Pᵀ dO,
//   dS = P∘(dO Vᵀ − Δ), dQ = dS K·scale, dK = dSᵀ Q·scale.
// As in the Pallas kernel, P and dS are rounded to bf16 before their
// products; everything else is fp32 until the bf16 gradients are written.

constexpr int BR = 64;              // backward frame block: rows of a stage (or 2·BR)
constexpr float LSE_PAD = 1e30f;    // lse2 of a padded query row: exp2(S − 1e30) = 0

struct BwdArgs {                     // pointers and (b, s, t) strides
  const __nv_bfloat16* in[5];        // q, k, v, dO, o: the order of a stage's tiles
  Strides ist[5];
  const float* lse;                  // (B, H, S, T) fp32, natural log
  const float* delta;                // (B, H, S, T) fp32 Δ, past BR frames (MULTI)
  __nv_bfloat16* out[3];             // dq, dk, dv
  Strides ost[3];
};

struct BwdPlan {      // the host's blocking of one launch
  int G;              // segments a work item
  int kr;             // rows a frame block holds: Tp up to BR, else BR or 2·BR
  int tiles;          // 16-row tiles a block: kr / 16
  int halves;         // 64-column halves of D
  int nb;             // blocks a segment
  int nseg;           // B·S·H
  int items;          // ceil(nseg / G) · nb
};

// One stage: bf16 [G][NT][kr][D] (Q, K, V, dO and, at T ≤ BR, O of frame
// block i, swizzled), then fp32 [G][2][kr] (lse2, Δ of the block's rows).
// MULTI (T > BR, G = 1): Δ comes from `block_attn_bwd_delta_kernel`, not O.
template <bool MULTI>
__host__ __device__ constexpr int bwd_tensors() {
  return MULTI ? 4 : 5;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int D, bool MULTI>
__device__ __forceinline__ void bwd_issue(__nv_bfloat16* stage, const BwdArgs& a,
                                          const BwdPlan& p, int S, int T, int H, int item,
                                          int step) {
  constexpr int CH = D / 8;
  const int grp = item / p.nb, j = item % p.nb;
  const int row0 = (j + step) % p.nb * p.kr;  // the frame block streamed at this step
  const int seg = bwd_tensors<MULTI>() * p.kr * D;
  float* fbase = reinterpret_cast<float*>(stage + p.G * seg);
  for (int g = 0; g < p.G; ++g) {
    const int u = grp * p.G + g;
    const bool live = u < p.nseg;
    const int h = u % H, s = u / H % S, b = u / H / S;
    __nv_bfloat16* d = stage + g * seg;
#pragma unroll
    for (int x = 0; x < bwd_tensors<MULTI>(); ++x) {
      const __nv_bfloat16* src = a.in[x];
      const Strides st = a.ist[x];
      const __nv_bfloat16* sb = live ? seg_base(src, st, b, s, h, D) : src;
      for (int e = threadIdx.x; e < p.kr * CH; e += blockDim.x) {
        const int c = e % CH, r = e / CH, t = row0 + r;
        const bool ok = live && t < T;
        cp_async16(smem_u32(d + x * p.kr * D + swz<D>(r, c)), ok ? sb + t * st.t + c * 8 : src,
                   ok);
      }
    }
    const long long rb = live ? (((long long)b * H + h) * S + s) * T + row0 : 0;
    float* fl = fbase + g * 2 * p.kr;
    for (int r = threadIdx.x; r < p.kr; r += blockDim.x) {
      const bool ok = live && row0 + r < T;
      cp_async4(smem_u32(fl + r), ok ? a.lse + rb + r : a.lse, ok);
      if (MULTI) cp_async4(smem_u32(fl + p.kr + r), ok ? a.delta + rb + r : a.delta, ok);
    }
  }
}

// A warp's 16×64 fp32 accumulator (rows gr, gr + 8 of 8-column tiles) × mul,
// as bf16 through the warp's 2 KB of shared staging, then out as 16-byte
// row stores to rows row0.. (those below T) of a (rows, ld) bf16 array.
__device__ __forceinline__ void bwd_store(__nv_bfloat16* stg, const float (&acc)[8][4],
                                          float mul, __nv_bfloat16* dst, long long ld,
                                          int row0, int T, bool live) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  uint32_t* stg32 = reinterpret_cast<uint32_t*>(stg);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    stg32[(swz<64>(gr, n) + 2 * tq) >> 1] = pack(acc[n][0] * mul, acc[n][1] * mul);
    stg32[(swz<64>(gr + 8, n) + 2 * tq) >> 1] = pack(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  for (int e = lane; e < 16 * 8; e += 32) {
    const int r = e / 8, c = e % 8;
    if (live && row0 + r < T)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(stg + swz<64>(r, c));
  }
  __syncwarp();
}

// Work item: G adjacent segments × one own frame block j (≤ 64 frames). Its
// warps come in two roles, each over (segment, own 16-row tile, 64-column
// half of D): key-major warps own a key tile and sum its dK and dV, query-
// major warps own a query tile and sum its dQ. The item streams every frame
// block i of its segments, j first, through the two-stage ring (Q, K, V,
// dO, O and lse of block i): key-major warps take block i's query tiles,
// query-major warps its key tiles. T ≤ 64 is one block, so an item reads
// each input once, and both roles read its one stage; past 64 frames the
// own block is copied out of the ring at the item's first step and the
// other blocks are read again from L2, once per own block (MULTI: Δ from
// the pre-pass instead of O; with 64-frame blocks at D = 64 the ring and
// the own block take 100 KB and two blocks fit an SM).
template <int D, bool MULTI>
__global__ void __launch_bounds__(D == 64 && !MULTI ? 256 : 512)
block_attn_bwd_kernel(BwdArgs a, int S, int T, int H, float scale, float scale_log2,
                      BwdPlan p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int CH = D / 8;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int seg = bwd_tensors<MULTI>() * p.kr * D;
  const int stage_elems = p.G * seg + p.G * 2 * p.kr * 2;  // bf16 units: floats count twice
  __nv_bfloat16* own = ring + 2 * stage_elems;  // MULTI: a copy of block j's stage
  const int Tp = pad16(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int role_warps = p.G * p.tiles * p.halves;
  const bool key_major = warp < role_warps;
  const int wr = key_major ? warp : warp - role_warps;
  const int my_g = wr / (p.tiles * p.halves), my_t = wr / p.halves % p.tiles,
            hf = wr % p.halves;

  float acc0[8][4], acc1[8][4];  // key-major: dK, dV; query-major: dQ in acc0

  int item = blockIdx.x, step = 0, slot = 0;
  if (item < p.items) bwd_issue<D, MULTI>(ring, a, p, S, T, H, item, 0);
  cp_async_commit();
  while (item < p.items) {
    int next = item, next_step = step + 1;
    if (next_step == p.nb) {
      next_step = 0;
      next += gridDim.x;
    }
    if (next < p.items)
      bwd_issue<D, MULTI>(ring + (slot ^ 1) * stage_elems, a, p, S, T, H, next, next_step);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();  // this stage's copies, from every thread, have landed

    const int grp = item / p.nb, j = item % p.nb, i = (j + step) % p.nb;
    __nv_bfloat16* stage = ring + slot * stage_elems;
    float* fbase = reinterpret_cast<float*>(stage + p.G * seg);
    if (MULTI) {
      // lse to log2 units (padded rows: LSE_PAD, so their P is 0); at the
      // item's first step the stage is also copied out as the own block
      float* of = reinterpret_cast<float*>(own + seg);
      for (int r = threadIdx.x; r < p.kr; r += blockDim.x) {
        const float l2 = grp < p.nseg && i * p.kr + r < T ? fbase[r] * LOG2E : LSE_PAD;
        fbase[r] = l2;
        if (step == 0) {
          of[r] = l2;
          of[p.kr + r] = fbase[p.kr + r];
        }
      }
      if (step == 0)
        for (int e = threadIdx.x; e < 4 * p.kr * CH; e += blockDim.x)
          reinterpret_cast<uint4*>(own)[e] = reinterpret_cast<const uint4*>(stage)[e];
    } else {
      // Δ = rowsum(dO∘O) from the stage's tiles, CH lanes a row; lse as above
      for (int e = threadIdx.x; e < p.G * p.kr * CH; e += blockDim.x) {
        const int c = e % CH, r = e / CH % p.kr, g = e / CH / p.kr;
        const __nv_bfloat16* xs = stage + g * seg + swz<D>(r, c);
        float dl = dot8(*reinterpret_cast<const uint4*>(xs + 3 * p.kr * D),
                        *reinterpret_cast<const uint4*>(xs + 4 * p.kr * D));
#pragma unroll
        for (int m = CH / 2; m; m >>= 1) dl += __shfl_xor_sync(FULL, dl, m);
        if (c == 0) {
          float* fl = fbase + g * 2 * p.kr;
          fl[r] = grp * p.G + g < p.nseg && r < T ? fl[r] * LOG2E : LSE_PAD;
          fl[p.kr + r] = dl;
        }
      }
    }
    __syncthreads();  // Δ, lse2 (and the own block) are in place

    if (step == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc0[n][e] = acc1[n][e] = 0.f;
    }
    // this warp's segment in the stage (block i) and in the own block j
    const __nv_bfloat16* sx = stage + my_g * seg;
    const float* sf = fbase + my_g * 2 * p.kr;
    const __nv_bfloat16* ox = MULTI ? own : sx;
    const float* of = MULTI ? reinterpret_cast<const float*>(own + seg) : sf;
    const int kr = p.kr;
    const int t16 = my_t * 16;
    // block i's live rows (a multiple of 16); none for a warp whose own tile
    // lies past T, in the last block of a ragged T > BR
    const int rows = t16 < Tp - j * kr ? min(kr, Tp - i * kr) : 0;

    if (key_major) {
      // Sᵀ = K_j Qᵢᵀ and dPᵀ = V_j dOᵢᵀ (16 keys × 16 queries), then
      // dV += Pᵀ dOᵢ and dK += dSᵀ Qᵢ with Pᵀ, dSᵀ as A fragments
      const __nv_bfloat16* oK = ox + kr * D;
      const __nv_bfloat16* oV = ox + 2 * kr * D;
      const __nv_bfloat16* sQ = sx;
      const __nv_bfloat16* sG = sx + 3 * kr * D;
      for (int uq = 0; uq * 16 < rows; ++uq) {
        float st[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t fa[4], fb[4];
          const int ca = 2 * kk + (lane >> 4), ra = t16 + (lane & 15);
          const int cb = 2 * kk + ((lane >> 3) & 1),
                    rb = uq * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(smem_u32(oK + swz<D>(ra, ca)), fa);
          ldsm_x4(smem_u32(sQ + swz<D>(rb, cb)), fb);
          mma16816(st[0], fa, fb[0], fb[1]);
          mma16816(st[1], fa, fb[2], fb[3]);
          ldsm_x4(smem_u32(oV + swz<D>(ra, ca)), fa);
          ldsm_x4(smem_u32(sG + swz<D>(rb, cb)), fb);
          mma16816(dp[0], fa, fb[0], fb[1]);
          mma16816(dp[1], fa, fb[2], fb[3]);
        }
        float pr[2][4], ds[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = uq * 16 + n * 8 + 2 * tq + (e & 1);
            pr[n][e] = exp2f(st[n][e] * scale_log2 - sf[q]);
            ds[n][e] = pr[n][e] * (dp[n][e] - sf[kr + q]);
          }
        }
        const uint32_t pa[4] = {pack(pr[0][0], pr[0][1]), pack(pr[0][2], pr[0][3]),
                                pack(pr[1][0], pr[1][1]), pack(pr[1][2], pr[1][3])};
        const uint32_t da[4] = {pack(ds[0][0], ds[0][1]), pack(ds[0][2], ds[0][3]),
                                pack(ds[1][0], ds[1][1]), pack(ds[1][2], ds[1][3])};
        const int rt = uq * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dc = 0; dc < 4; ++dc) {
          const int ct = 2 * (hf * 4 + dc) + (lane >> 4);
          uint32_t fb[4];
          ldsm_x4_trans(smem_u32(sG + swz<D>(rt, ct)), fb);
          mma16816(acc1[2 * dc], pa, fb[0], fb[1]);
          mma16816(acc1[2 * dc + 1], pa, fb[2], fb[3]);
          ldsm_x4_trans(smem_u32(sQ + swz<D>(rt, ct)), fb);
          mma16816(acc0[2 * dc], da, fb[0], fb[1]);
          mma16816(acc0[2 * dc + 1], da, fb[2], fb[3]);
        }
      }
    } else {
      // S = Q_j Kᵢᵀ and dP = dO_j Vᵢᵀ (16 queries × 16 keys), then
      // dQ += dS Kᵢ with dS as the A fragment; keys past T get P = 0
      const __nv_bfloat16* oQ = ox;
      const __nv_bfloat16* oG = ox + 3 * kr * D;
      const __nv_bfloat16* sK = sx + kr * D;
      const __nv_bfloat16* sV = sx + 2 * kr * D;
      const float l0 = of[t16 + gr], l1 = of[t16 + gr + 8];
      const float d0 = of[kr + t16 + gr], d1 = of[kr + t16 + gr + 8];
      for (int uk = 0; uk * 16 < rows; ++uk) {
        float st[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t fa[4], fb[4];
          const int ca = 2 * kk + (lane >> 4), ra = t16 + (lane & 15);
          const int cb = 2 * kk + ((lane >> 3) & 1),
                    rb = uk * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(smem_u32(oQ + swz<D>(ra, ca)), fa);
          ldsm_x4(smem_u32(sK + swz<D>(rb, cb)), fb);
          mma16816(st[0], fa, fb[0], fb[1]);
          mma16816(st[1], fa, fb[2], fb[3]);
          ldsm_x4(smem_u32(oG + swz<D>(ra, ca)), fa);
          ldsm_x4(smem_u32(sV + swz<D>(rb, cb)), fb);
          mma16816(dp[0], fa, fb[0], fb[1]);
          mma16816(dp[1], fa, fb[2], fb[3]);
        }
        float ds[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = i * kr + uk * 16 + n * 8 + 2 * tq + (e & 1);
            const float pv = key < T ? exp2f(st[n][e] * scale_log2 - (e < 2 ? l0 : l1)) : 0.f;
            ds[n][e] = pv * (dp[n][e] - (e < 2 ? d0 : d1));
          }
        }
        const uint32_t da[4] = {pack(ds[0][0], ds[0][1]), pack(ds[0][2], ds[0][3]),
                                pack(ds[1][0], ds[1][1]), pack(ds[1][2], ds[1][3])};
        const int rt = uk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dc = 0; dc < 4; ++dc) {
          uint32_t fb[4];
          ldsm_x4_trans(smem_u32(sK + swz<D>(rt, 2 * (hf * 4 + dc) + (lane >> 4))), fb);
          mma16816(acc0[2 * dc], da, fb[0], fb[1]);
          mma16816(acc0[2 * dc + 1], da, fb[2], fb[3]);
        }
      }
    }

    if (step == p.nb - 1) {  // epilogue: every warp has read this stage
      __syncthreads();
      const int u = grp * p.G + my_g;
      const bool live = u < p.nseg;
      const int h = u % H, s = u / H % S, b = u / H / S;
      const int row0 = j * kr + t16;
      __nv_bfloat16* stg = stage + warp * 16 * 64;
      if (key_major) {
        bwd_store(stg, acc1, 1.f, seg_base(a.out[2], a.ost[2], b, s, h, D) + hf * 64,
                  a.ost[2].t, row0, T, live);
        bwd_store(stg, acc0, scale, seg_base(a.out[1], a.ost[1], b, s, h, D) + hf * 64,
                  a.ost[1].t, row0, T, live);
      } else {
        bwd_store(stg, acc0, scale, seg_base(a.out[0], a.ost[0], b, s, h, D) + hf * 64,
                  a.ost[0].t, row0, T, live);
      }
    }
    __syncthreads();  // this stage is free for the copies issued next round
    item = next;
    step = next_step;
    slot ^= 1;
  }
}

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int S, int T, int H, const long long* st, float scale,
                       cudaStream_t stream) {
  const int Tp = pad16(T), mt = Tp / 16;
  FwdPlan p;
  p.nqc = (mt + FWD_WARPS - 1) / FWD_WARPS;
  p.qt = (mt + p.nqc - 1) / p.nqc;
  p.kr = Tp < KB ? Tp : KB;
  p.nkb = (Tp + KB - 1) / KB;
  const int seg_bytes = (p.qt * 16 + 2 * p.kr) * D * 2;
  p.G = std::max(1, FWD_GROUP_WARPS / p.qt);
  while (p.G > 1 && 2 * p.G * seg_bytes > FWD_RING_CAP) --p.G;
  const long long nseg = (long long)B * S * H;
  if (nseg * p.nqc >= (1ll << 31)) return cudaErrorInvalidValue;
  p.nseg = (int)nseg;
  p.items = (p.nseg + p.G - 1) / p.G * p.nqc;
  const int threads = p.G * p.qt * 32;
  const int smem = 2 * p.G * seg_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_attn_fwd_kernel<D>,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(p.items, per_sm * sm_count());
  block_attn_fwd_kernel<D><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, T, H, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), scale * LOG2E, p);
  return cudaGetLastError();
}

// Δ = rowsum(dO∘O) for T > BR, where every block of a segment is streamed
// once per own block: (B, H, S, T) fp32 into `delta`, D/8 lanes a row, 16
// bytes a lane.
template <int D>
__global__ void __launch_bounds__(256)
block_attn_bwd_delta_kernel(BwdArgs a, float* __restrict__ delta, int S, int T, int H,
                            long long rows) {
  constexpr int CH = D / 8;
  const long long lanes = rows * CH;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e - (threadIdx.x & 31) < lanes; e += (long long)gridDim.x * blockDim.x) {
    const bool live = e < lanes;
    const long long row = live ? e / CH : 0;
    const int c = (int)(e % CH), t = (int)(row % T);
    const int u = (int)(row / T), h = u % H, s = u / H % S, b = u / H / S;
    float dl = 0.f;
    if (live) {
      const __nv_bfloat16* g = seg_base(a.in[3], a.ist[3], b, s, h, D) + t * a.ist[3].t + c * 8;
      const __nv_bfloat16* o = seg_base(a.in[4], a.ist[4], b, s, h, D) + t * a.ist[4].t + c * 8;
      dl = dot8(*reinterpret_cast<const uint4*>(g), *reinterpret_cast<const uint4*>(o));
    }
#pragma unroll
    for (int m = CH / 2; m; m >>= 1) dl += __shfl_xor_sync(FULL, dl, m);
    if (live && c == 0) delta[(((long long)b * H + h) * S + s) * T + t] = dl;
  }
}

template <int D, bool MULTI>
cudaError_t launch_bwd_kernel(const BwdArgs& a, BwdPlan p, int S, int T, int H, float scale,
                              cudaStream_t stream) {
  const int seg_warps = 2 * p.tiles * p.halves;  // both roles
  const int max_warps = D == 64 && !MULTI ? 8 : 16;
  const size_t seg_bytes = (size_t)bwd_tensors<MULTI>() * p.kr * D * 2 + (size_t)2 * p.kr * 4;
  const size_t own_bytes = MULTI ? seg_bytes : 0;
  p.G = MULTI ? 1 : std::max(1, max_warps / seg_warps);
  while (p.G > 1 && 2 * p.G * seg_bytes + own_bytes > (size_t)SMEM_MAX) --p.G;
  const size_t smem = 2 * p.G * seg_bytes + own_bytes;
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  p.items = (p.nseg + p.G - 1) / p.G * p.nb;
  const int threads = p.G * seg_warps * 32;
  cudaError_t err = cudaFuncSetAttribute(block_attn_bwd_kernel<D, MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_attn_bwd_kernel<D, MULTI>,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(p.items, per_sm * sm_count());
  block_attn_bwd_kernel<D, MULTI><<<(unsigned)grid, threads, smem, stream>>>(
      a, S, T, H, scale, scale * LOG2E, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int B, int S, int T, int H, const long long* st, float scale,
                       cudaStream_t stream) {
  const int Tp = pad16(T);
  BwdPlan p;
  // frames a block: BR up to BR (one block), then 64, or at D = 64 from 256
  // frames 128 (half the re-streaming and twice the work a barrier; at
  // T = 136 the smaller blocks pad less and won, by timing variants)
  const int rb = D == 64 && Tp >= 256 ? 2 * BR : BR;
  p.kr = Tp < rb ? Tp : rb;
  p.tiles = p.kr / 16;
  p.halves = D / 64;
  p.nb = (Tp + rb - 1) / rb;
  const long long nseg = (long long)B * S * H;
  if (nseg * p.nb >= (1ll << 31)) return cudaErrorInvalidValue;
  p.nseg = (int)nseg;
  BwdArgs a;
  const void* ins[5] = {q, k, v, dout, o};
  const int in_idx[5] = {0, 1, 2, 4, 3};  // strides arrive as q, k, v, o, dO
  for (int x = 0; x < 5; ++x) {
    a.in[x] = static_cast<const __nv_bfloat16*>(ins[x]);
    a.ist[x] = strides_at(st, in_idx[x]);
  }
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  void* outs[3] = {dq, dk, dv};
  for (int x = 0; x < 3; ++x) {
    a.out[x] = static_cast<__nv_bfloat16*>(outs[x]);
    a.ost[x] = strides_at(st, 5 + x);
  }
  if (Tp <= BR) return launch_bwd_kernel<D, false>(a, p, S, T, H, scale, stream);
  const long long rows = nseg * T;
  const long long blocks = std::min<long long>((rows * (D / 8) + 255) / 256, 16ll * sm_count());
  block_attn_bwd_delta_kernel<D><<<(unsigned)blocks, 256, 0, stream>>>(
      a, static_cast<float*>(delta), S, T, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd_kernel<D, true>(a, p, S, T, H, scale, stream);
}

}  // namespace

// q, k, v: (B, S, T, H, D) bf16 views, head stride D, unit dim stride, every
// (b, s, t) stride a multiple of 8 elements and 16-byte aligned bases; T ≥ 2.
// strides: 12 element strides (b, s, t) for q, k, v, o in that order. lse is
// written contiguous (B, H, S, T) fp32, in natural-log units.
extern "C" int hi3d_block_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int S, int T, int H, int D,
                                        const long long* strides, float scale, void* stream) {
  if (T < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_fwd<64>(q, k, v, o, lse, B, S, T, H, strides, scale, st);
    case 128: return (int)launch_fwd<128>(q, k, v, o, lse, B, S, T, H, strides, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// strides: 24 element strides (b, s, t) for q, k, v, o, dO, dq, dk, dv in that
// order; lse is the forward's (B, H, S, T) fp32; delta is (B, H, S, T) fp32
// scratch, used past 64 frames. T ≥ 2.
extern "C" int hi3d_block_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B,
                                        int S, int T, int H, int D, const long long* strides,
                                        float scale, void* stream) {
  if (T < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, strides,
                                 scale, st);
    case 128:
      return (int)launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, strides,
                                  scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
