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
// Backward (#7): one thread block owns one segment (Tp/16
// warps, T ≤ 256): Q and dO of the whole segment stay in shared memory, keys
// go in blocks of at most 128 frames (fewer where shared memory is short;
// T ≤ 128 is one block). Per key block
// P = exp2(S·scale·log2e − lse·log2e) is recomputed from the forward's lse,
// so no online softmax; dK and dV of the block's keys are complete when the
// block is done, and dQ accumulates in fp32 fragments across key blocks in
// the warp that owns its rows: no atomics, the same result every run. WMMA
// bf16 m16n16k16 tiles, P and dS rounded to bf16 before their products as
// in the Pallas kernel. Shared memory: 4·Tp·D + 4·KB·D + 4·Tp·KB + 128·Tp
// bytes for key blocks of KB rows (208 KB at T = 256, D = 128, KB = 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

using namespace nvcuda;

namespace {

constexpr int KB = 64;              // forward key block (frames)
constexpr int FWD_WARPS = 8;        // forward warps a block, at most (query tiles a chunk)
constexpr int FWD_GROUP_WARPS = 4;  // forward: segments are grouped up to this many warps
constexpr int MAX_BWD_T = 256;      // backward: one warp per 16 query rows
constexpr int BWD_KB = 128;         // backward key block, at most
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use
constexpr int FWD_RING_CAP = 113 * 1024;  // two forward blocks to an SM
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

// ------------------------------------------------------- PTX building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; zeros when !valid (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group of this thread's copies is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk c of row r in a swizzled (rows, D) tile.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
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
//   P = exp(Q K^T·scale − lse), Δ_i = dO_i·O_i, dV = P^T dO,
//   dS = P∘(dO V^T − Δ), dQ = dS K·scale, dK = dS^T Q·scale.
// As in the Pallas kernel, P and dS are rounded to bf16 before their
// products; everything else is fp32 until the bf16 gradients are written.
//
// Per key block of kb rows: phase 1, warp w forms rows 16w.. of P and dS
// (bf16, shared, kb columns) one 16x16 tile at a time through two fp32
// staging tiles (S, then dO V^T). Phase 2, the block's (key tile, column
// tile) pairs of dK and dV go round the warps, each reading P and dS
// transposed (col-major fragments) over every query tile, and warp w adds
// dS rows 16w.. times the block's K to its fp32 dQ fragments. Each gradient
// element is written by exactly one warp: no atomics, the same result every
// run.

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// ONE_BLOCK (T ≤ 128, 256 threads): Q and dO fragments stay in registers
// and each dQ tile leaves as soon as it is summed. Otherwise
// (T ≤ 256, 512 threads, so at most 128 registers) the fragments are read
// from shared memory where they are used and dQ stays in fp32 fragments
// across the key blocks.
template <int D, bool ONE_BLOCK>
__global__ void __launch_bounds__(ONE_BLOCK ? 256 : 512)
block_attn_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int T, int H, int kbr, Strides qs,
                      Strides ks, Strides vs, Strides os, Strides gs, Strides dqs, Strides dks,
                      Strides dvs, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int Tp = pad16(T);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sG = sQ + Tp * D;  // dO
  __nv_bfloat16* sK = sG + Tp * D;  // this key block's K and V, kbr rows
  __nv_bfloat16* sV = sK + kbr * D;
  __nv_bfloat16* sP = sV + kbr * D;  // (Tp, kbr)
  __nv_bfloat16* sD = sP + Tp * kbr;  // dS
  float* sStage = reinterpret_cast<float*>(sD + Tp * kbr);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const long long item = blockIdx.x;
  const int h = (int)(item % H);
  const long long bs = item / H;
  const int s = (int)(bs % S), b = (int)(bs / S);

  load_rows<D>(sQ, seg_base(q, qs, b, s, h, D), qs.t, T, Tp);
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
  __nv_bfloat16* dqb = seg_base(dq, dqs, b, s, h, D);
  __nv_bfloat16* dkb = seg_base(dk, dks, b, s, h, D);
  __nv_bfloat16* dvb = seg_base(dv, dvs, b, s, h, D);
  constexpr int NQF = ONE_BLOCK ? D / 16 : 1, NAQ = ONE_BLOCK ? 1 : D / 16;
  FragC aq[NAQ];
#pragma unroll
  for (int n = 0; n < NAQ; ++n) wmma::fill_fragment(aq[n], 0.f);
  FragA qf[NQF], gf[NQF];
  if (ONE_BLOCK) {
#pragma unroll
    for (int kk = 0; kk < NQF; ++kk) {
      wmma::load_matrix_sync(qf[kk], sQ + i0 * D + kk * 16, D);
      wmma::load_matrix_sync(gf[kk], sG + i0 * D + kk * 16, D);
    }
  }

  for (int kb0 = 0; kb0 < Tp; kb0 += kbr) {
    const int nk = min(kbr, Tp - kb0), nkt = nk / 16;
    if (kb0 > 0) __syncthreads();  // the previous key block is no longer read
    load_rows<D>(sK, seg_base(k, ks, b, s, h, D) + kb0 * ks.t, ks.t, T - kb0, nk);
    load_rows<D>(sV, seg_base(v, vs, b, s, h, D) + kb0 * vs.t, vs.t, T - kb0, nk);
    __syncthreads();

    for (int n = 0; n < nkt; ++n) {
      FragC sf, dpf;
      wmma::fill_fragment(sf, 0.f);
      wmma::fill_fragment(dpf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int f = ONE_BLOCK ? kk : 0;
        if (!ONE_BLOCK) {
          wmma::load_matrix_sync(qf[0], sQ + i0 * D + kk * 16, D);
          wmma::load_matrix_sync(gf[0], sG + i0 * D + kk * 16, D);
        }
        FragBt kf, vf;
        wmma::load_matrix_sync(kf, sK + n * 16 * D + kk * 16, D);
        wmma::mma_sync(sf, qf[f], kf, sf);
        wmma::load_matrix_sync(vf, sV + n * 16 * D + kk * 16, D);
        wmma::mma_sync(dpf, gf[f], vf, dpf);
      }
      wmma::store_matrix_sync(st0, sf, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st1, dpf, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = half * 8 + e, j = kb0 + n * 16 + c;
        float p = 0.f, ds = 0.f;
        if (i < T && j < T) {
          p = exp2f(st0[r * 16 + c] * scale_log2 - lse2);
          ds = p * (st1[r * 16 + c] - delta);
        }
        sP[i * kbr + n * 16 + c] = __float2bfloat16(p);
        sD[i * kbr + n * 16 + c] = __float2bfloat16(ds);
      }
      __syncwarp();
    }
    __syncthreads();  // every warp's rows of P and dS are in place

    // dV_j = Σ_i P_ij dO_i and dK_j = Σ_i dS_ij Q_i for the block's key tiles
    for (int unit = warp; unit < nkt * (D / 16); unit += nwarps) {
      const int j0 = (unit % nkt) * 16, n = unit / nkt;
      FragC av, ak;
      wmma::fill_fragment(av, 0.f);
      wmma::fill_fragment(ak, 0.f);
      for (int t = 0; t < Tp / 16; ++t) {
        FragAt pt, dst;
        FragB gb, qb;
        wmma::load_matrix_sync(pt, sP + t * 16 * kbr + j0, kbr);
        wmma::load_matrix_sync(gb, sG + t * 16 * D + n * 16, D);
        wmma::mma_sync(av, pt, gb, av);
        wmma::load_matrix_sync(dst, sD + t * 16 * kbr + j0, kbr);
        wmma::load_matrix_sync(qb, sQ + t * 16 * D + n * 16, D);
        wmma::mma_sync(ak, dst, qb, ak);
      }
      wmma::store_matrix_sync(st0, av, 16, wmma::mem_row_major);
      __syncwarp();
      store_tile(dvb + n * 16, dvs.t, st0, kb0 + j0, T, 1.f);
      __syncwarp();
      wmma::store_matrix_sync(st0, ak, 16, wmma::mem_row_major);
      __syncwarp();
      store_tile(dkb + n * 16, dks.t, st0, kb0 + j0, T, scale);
      __syncwarp();
    }
    // dQ_i += Σ_j dS_ij K_j over this block's keys (rows i0.. of dS)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC& acc = aq[ONE_BLOCK ? 0 : n];
      if (ONE_BLOCK) wmma::fill_fragment(acc, 0.f);
      for (int t = 0; t < nkt; ++t) {
        FragA dsf;
        FragB kf;
        wmma::load_matrix_sync(dsf, sD + i0 * kbr + t * 16, kbr);
        wmma::load_matrix_sync(kf, sK + t * 16 * D + n * 16, D);
        wmma::mma_sync(acc, dsf, kf, acc);
      }
      if (kb0 + nk == Tp) {  // the last key block: dQ rows i0.., columns n·16.. are done
        wmma::store_matrix_sync(st0, acc, 16, wmma::mem_row_major);
        __syncwarp();
        store_tile(dqb + n * 16, dqs.t, st0, i0, T, scale);
        __syncwarp();
      }
    }
  }
}

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

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

size_t bwd_smem(int Tp, int kbr, int D) {
  return (size_t)4 * Tp * D + (size_t)4 * kbr * D + (size_t)4 * Tp * kbr + (size_t)128 * Tp;
}

template <int D, bool ONE_BLOCK>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* dq, void* dk, void* dv, int B,
                       int S, int T, int H, const long long* st, float scale,
                       cudaStream_t stream) {
  const int Tp = pad16(T);
  int kbr = Tp < BWD_KB ? Tp : BWD_KB;
  while (kbr > 16 && bwd_smem(Tp, kbr, D) > (size_t)SMEM_MAX) kbr /= 2;
  const size_t smem = bwd_smem(Tp, kbr, D);
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_bwd_kernel<D, ONE_BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)B * S * H;
  block_attn_bwd_kernel<D, ONE_BLOCK><<<(unsigned)items, Tp * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, T, H, kbr, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), strides_at(st, 5),
      strides_at(st, 6), strides_at(st, 7), scale, scale * LOG2E);
  return cudaGetLastError();
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
// order; lse is the forward's (B, H, S, T) fp32. 2 ≤ T ≤ 256.
extern "C" int hi3d_block_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv, int B, int S, int T,
                                        int H, int D, const long long* strides, float scale,
                                        void* stream) {
  if (T < 2 || T > MAX_BWD_T || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = pad16(T) <= BWD_KB;
  auto launch = D == 64 ? (one ? launch_bwd<64, true> : launch_bwd<64, false>)
                        : (one ? launch_bwd<128, true> : launch_bwd<128, false>);
  return (int)launch(q, k, v, o, dout, lse, dq, dk, dv, B, S, T, H, strides, scale, st);
}
