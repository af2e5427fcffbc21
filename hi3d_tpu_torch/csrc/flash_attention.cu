// Spatial flash attention for Hopper (sm_90a): K1, the forward (bf16 Q/K/V,
// fp32 online-softmax state, bf16 O and natural-log lse out), and #3, its
// backward (Δ, then a dK/dV pass and a dQ pass).
//
// K1 replaces the Pallas kernel hi3d_tpu/ops/flash_attention.py:_fwd
// (_fwd_kernel_vaug / _fwd_kernel): O = softmax(Q Kᵀ·scale) V with the online
// softmax in the exp2 domain. #3 replaces _bwd (_dkv_kernel, _dq_kernel).
//
// What bounds them on the H100: at the UNet's shapes (S = 4096/1024 tokens,
// D = 64) attention is compute bound, 4·S·D flops per 2·D·2 bytes read per
// key-query pair, so the design is about the tensor-core rate: every product
// is a warpgroup `wgmma` (the only route to the card's bf16 peak), every tile
// arrives by TMA into a ring guarded by mbarriers while the previous one is
// used, and no fp32 score, probability or accumulator tile goes through
// shared memory.
//
// Block layout (all three kernels): 384 threads, two consumer warpgroups of
// 64 rows each and one producer warpgroup. The producer gives up registers
// (setmaxnreg 40) and one of its threads issues the TMA loads; the consumers
// take them (setmaxnreg 232). Tiles are stored as 128-byte-swizzled 64-column
// atoms (hopper.cuh); D = 80 is zero-padded to two atoms (128 columns) by the
// TMA itself (columns past D read as zeros), so D ∈ {64, 80, 128} share one
// path, D = 80 at D = 128's cost.
//
// K1, one block per (b, h, 128-query tile):
//   Q is loaded once; 128-key tiles of K and V stream through a ring of
//   3 (D = 64) or 2 stages, K and V on separate "full" barriers so that
//   S = Q Kᵀ (wgmma m64n128k16, Q and K both K-major from shared memory)
//   starts before V has landed. The softmax runs on the fp32 accumulator in
//   registers: a row's 128 scores sit in the 4 threads of a quad, so its max
//   is two shuffles, and its sum stays a per-thread partial until the end.
//   P is rounded to bf16 in registers into the A operand of O += P V (wgmma
//   with A from registers, V as an MN-major B operand), and the O accumulator
//   (64 × D fp32 per warpgroup) is rescaled in registers. Keys past Sk are
//   masked to −∞ before the max; rows past Sq load as zeros and are not
//   stored. The epilogue normalises by 1/l, stages O as bf16 in the block's
//   own (now unused) Q rows and writes it with 16-byte coalesced stores, and
//   writes lse = (m + log2 l)·ln 2.
//
// #3, deterministic and without atomics, as on the TPU: Δ = rowsum(dO∘O)
// first, then
//   (a) one block per (b, h, 128-key tile): K and V stay in shared memory,
//       64-query tiles of Q and dO stream through the ring with their
//       lse·log2 e and Δ (written to the stage by the producer warp).
//       Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are wgmma with K-major operands;
//       Pᵀ = exp2(Sᵀ·scale·log2 e − lse) and dSᵀ = Pᵀ∘(dPᵀ − Δ) are formed
//       in registers and rounded to bf16 there; dV += Pᵀ dO and
//       dK += dSᵀ Q take A from registers and dO, Q as MN-major B operands.
//       dK and dV accumulate in registers for the whole walk.
//   (b) one block per (b, h, 128-query tile): Q and dO stay, 64-key tiles of
//       K and V stream; S = Q Kᵀ and dP = dO Vᵀ as in (a), dS in registers,
//       dQ += dS K with K as the MN-major B operand.
//   P is recomputed from the forward's natural-log lse in the forward's exp2
//   domain; `scale` enters dQ and dK once, at the final write. Queries past
//   Sq get lse = +∞ in (a), so their P is exactly 0; keys past Sk are masked
//   to P = 0 in (b).
//
// What was hard, and where it is answered:
//   - The TMA encoder lives in libcuda and the library links without
//     -lcuda: hopper::tensor_map_encoder fetches it through the runtime. The
//     maps are encoded on the host at every call (the pointers change) and
//     passed by value as __grid_constant__ parameters.
//   - MN-major B operands (V in K1; dO, Q in (a); K in (b)) under the
//     128-byte swizzle: their descriptor steps 1024 bytes per 8 rows of the
//     reduction axis and a whole atom (rows × 128 bytes) per 64 output
//     columns (hopper::sw128_desc); a k16 step is 16 rows = 2048 bytes.
//     K-major operands step 32 bytes inside the atom per k16 step.
//   - Registers: at D = 128 a K1 consumer holds S (64), P (32) and O (64);
//     an (a) consumer dK and dV (128) beside Sᵀ and dPᵀ (64). setmaxnreg
//     gives the consumers 232 each.
//   - The accumulator and A-operand layouts of wgmma line up (hopper.cuh), so
//     P and dS go from accumulator to A operand by packing pairs.
//
// Inputs are (B, S, H, D) with any batch/sequence/head strides that are
// multiples of 8 elements and a unit D stride, so a (B, S, H·D) nn.Linear
// output goes in without a copy (the TMA maps are rank 4 over (D, H, S, B)).
// The block-diagonal seg_len mask of the Pallas kernels is not on the
// spatial path and is not implemented.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 384;  // two consumer warpgroups and a producer warpgroup
constexpr int CONSUMERS = 256;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// Head dim padded to whole 64-column atoms.
template <int D>
__host__ __device__ constexpr int padded() { return D <= 64 ? 64 : 128; }

template <int DP>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return (uint32_t)rows * DP * 2; }

// Dynamic shared memory starts at the next 1024-byte boundary (the swizzle
// atoms need it); the launch asks for 1 KB more than the layout.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return raw + pad;
}

// Issue the TMA loads of one tile (all its atoms) of `map` at sequence row
// `s0` into `dst` (`rows` rows per atom), on barrier `bar`.
template <int DP>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int h, int s0, int b) {
#pragma unroll
  for (int a = 0; a < DP / 64; ++a) tma_load_4d(dst + a * rows * 128, map, bar, a * 64, h, s0, b);
}

// The consumer thread's place in its warpgroup's wgmma fragments.
struct Lane {
  int tid, warp, g, qd;  // thread in warpgroup, warp in warpgroup, lane / 4, lane % 4
  __device__ Lane() {
    tid = threadIdx.x % 128;
    warp = tid / 32;
    g = (tid % 32) / 4;
    qd = tid % 4;
  }
};

// The bf16 A operand of every k16 step kk from a 64 × N fp32 accumulator
// (see hopper.cuh: values 8kk..8kk+7 in pairs).
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
}

// Write a consumer warpgroup's 64 × D fp32 accumulator, row i times mul[i % 2
// of the fragment], as bf16 rows row0.. of a (rows, H·D)-strided output at
// `dst` with 16-byte coalesced stores, staged through the warpgroup's own
// rows [wg_row0, wg_row0 + 64) of the swizzled `tile` (`tile_rows` rows per
// atom), which no product reads any more; rows ≥ S are dropped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[padded<D>() / 2], const float (&mul)[2],
                                           unsigned char* tile, int tile_rows, int wg_row0,
                                           bf16* dst, long long row_stride, int row0, int S,
                                           int barrier_id, const Lane& ln) {
  named_sync(barrier_id, 128);  // every warp's products on these rows are done
#pragma unroll
  for (int j = 0; j < padded<D>() / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wg_row0 + ln.warp * 16 + ln.g + 8 * i;
      *reinterpret_cast<uint32_t*>(tile + sw128_offset(row, j, tile_rows) + ln.qd * 4) =
          pack_bf16(acc[4 * j + 2 * i] * mul[i], acc[4 * j + 2 * i + 1] * mul[i]);
    }
  named_sync(barrier_id, 128);
  constexpr int CHUNKS = D / 8;
  for (int e = ln.tid; e < 64 * CHUNKS; e += 128) {
    const int r = e / CHUNKS, c = e % CHUNKS;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + sw128_offset(wg_row0 + r, c, tile_rows));
  }
}

// ----------------------------------------------------------------- forward

constexpr int FWD_BQ = 128, FWD_BK = 128;

template <int D>
struct FwdLayout {
  static constexpr int DP = padded<D>();
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  static constexpr uint32_t Q = tile_bytes<DP>(FWD_BQ), KV = tile_bytes<DP>(FWD_BK);
  static constexpr uint32_t BARS = Q + 2 * STAGES * KV;  // q_full, k_full[], v_full[], empty[]
  static constexpr uint32_t BYTES = BARS + (1 + 3 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              float* __restrict__ lse, int Sq, int Sk, int H, float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int DP = L::DP, ST = L::STAGES, BK = FWD_BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + L::Q;
  unsigned char* sV = sK + ST * L::KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  const int q0 = blockIdx.x * FWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (Sk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, L::Q);
      load_tile<DP>(sQ, &tq, q_full, FWD_BQ, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % ST, n = j / ST;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        mbar_arrive_expect_tx(&k_full[s], L::KV);
        load_tile<DP>(sK + s * L::KV, &tk, &k_full[s], BK, h, j * BK, b);
        mbar_arrive_expect_tx(&v_full[s], L::KV);
        load_tile<DP>(sV + s * L::KV, &tv, &v_full[s], BK, h, j * BK, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  float acc_o[DP / 2], acc_s[BK / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) acc_s[i] = 0.f;
  float m_i[2] = {-1e30f, -1e30f}, l_i[2] = {0.f, 0.f};  // not −∞: exp2(−∞ − −∞) is NaN

  // A operand: this warpgroup's 64 query rows
  const uint64_t dq = sw128_desc(smem_u32(sQ) + wg * 64 * 128, 16, 1024);
  mbar_wait(q_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int s = j % ST;
    const uint32_t par = (j / ST) & 1;
    const uint32_t k_addr = smem_u32(sK + s * L::KV), v_addr = smem_u32(sV + s * L::KV);

    // S = Q Kᵀ
    mbar_wait(&k_full[s], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * FWD_BQ * 128 + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
      mma_ss<BK>(acc_s, dq + (off >> 4), sw128_desc(k_addr + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);

    if ((j + 1) * BK > Sk) {  // keys past Sk
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (j * BK + 8 * (i / 4) + 2 * ln.qd + (i & 1) >= Sk) acc_s[i] = -CUDART_INF_F;
    }

    // online softmax on the two rows this thread holds (i = 0: row g, 1: g + 8)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
        mx = fmaxf(mx, fmaxf(acc_s[4 * c + 2 * i], acc_s[4 * c + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx * scale_log2);
      const float alpha = ex2(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(acc_s[4 * c + 2 * i + e], scale_log2, -m_new));
          acc_s[4 * c + 2 * i + e] = p;
          sum += p;
        }
      l_i[i] = l_i[i] * alpha + sum;  // this thread's part of the row sum
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        acc_o[4 * c + 2 * i] *= alpha;
        acc_o[4 * c + 2 * i + 1] *= alpha;
      }
    }
    uint32_t pa[BK / 16][4];
    to_a_operand<BK>(acc_s, pa);

    // O += P V
    mbar_wait(&v_full[s], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs_mn<DP>(acc_o, pa[kk], sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    inv[i] = 1.f / l_i[i];
  }
  const int row0 = q0 + wg * 64;
  store_rows<D>(acc_o, inv, sQ, FWD_BQ, wg * 64, o + ((long long)b * Sq * H + h) * D,
                (long long)H * D, row0, Sq, 1 + wg, ln);
  if (ln.qd == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + ln.warp * 16 + ln.g + 8 * i;
      if (row < Sq) lse[((long long)b * H + h) * Sq + row] = (m_i[i] + log2f(l_i[i])) * LN2;
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int BWD_RES = 128;   // resident rows per block (keys in (a), queries in (b))
constexpr int BWD_TILE = 64;   // streamed rows per stage
constexpr int BWD_STAGES = 3;

template <int D>
struct BwdLayout {
  static constexpr int DP = padded<D>();
  static constexpr uint32_t RES = tile_bytes<DP>(BWD_RES), TILE = tile_bytes<DP>(BWD_TILE);
  // two resident tiles, then per stage two streamed tiles, then (in (a))
  // per stage lse·log2 e and Δ of the 64 queries, then the barriers
  static constexpr uint32_t STREAM = 2 * RES;
  static constexpr uint32_t ROWS = STREAM + 2 * BWD_STAGES * TILE;
  static constexpr uint32_t BARS = ROWS + BWD_STAGES * 2 * BWD_TILE * 4;
  static constexpr uint32_t BYTES = BARS + (1 + 2 * BWD_STAGES) * 8 + 1024;
};

// Δ[b, h, i] = Σ_d dO[b, i, h, d]·O[b, i, h, d]; one warp per row.
__global__ void __launch_bounds__(128)
fa_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    float* __restrict__ delta, int B, int Sq, int H, int D,
                    long long o_sb, long long o_ss, long long o_sh,
                    long long d_sb, long long d_ss, long long d_sh) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
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

// (a): dK and dV for one (b, h, 128-key tile).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                  float scale, float scale_log2) {
  using L = BwdLayout<D>;
  constexpr int DP = L::DP, ST = BWD_STAGES, BQ = BWD_TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::RES;
  unsigned char* sQ = smem + L::STREAM;          // stage s at sQ + s·TILE
  unsigned char* sG = sQ + ST * L::TILE;         // dO
  float* sL = reinterpret_cast<float*>(smem + L::ROWS);  // stage s: lse·log2 e at sL + 2·64·s, Δ after
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_full = kv_full + 1;
  uint64_t* empty = q_full + ST;

  const int k0 = blockIdx.x * BWD_RES, h = blockIdx.y, b = blockIdx.z;
  const int nq = (Sq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&q_full[s], 32);  // the producer warp's lanes (lse, Δ) and the TMA bytes
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x & 31;
      const float* lse_b = lse + ((long long)b * H + h) * Sq;
      const float* delta_b = delta + ((long long)b * H + h) * Sq;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::RES);
        load_tile<DP>(sK, &tk, kv_full, BWD_RES, h, k0, b);
        load_tile<DP>(sV, &tv, kv_full, BWD_RES, h, k0, b);
      }
      for (int i = 0; i < nq; ++i) {
        const int s = i % ST, n = i / ST;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        float* l_s = sL + 2 * BQ * s;
        for (int r = lane; r < BQ; r += 32) {
          const int q = i * BQ + r;
          l_s[r] = q < Sq ? lse_b[q] * LOG2E : CUDART_INF_F;  // P = 0 past Sq
          l_s[BQ + r] = q < Sq ? delta_b[q] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&q_full[s], 2 * L::TILE);
          load_tile<DP>(sQ + s * L::TILE, &tq, &q_full[s], BQ, h, i * BQ, b);
          load_tile<DP>(sG + s * L::TILE, &tg, &q_full[s], BQ, h, i * BQ, b);
        } else {
          mbar_arrive(&q_full[s]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  float acc_dk[DP / 2], acc_dv[DP / 2], acc_s[32], acc_dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_s[i] = acc_dp[i] = 0.f;

  // A operands: this warpgroup's 64 key rows of K and V
  const uint64_t dk_a = sw128_desc(smem_u32(sK) + wg * 64 * 128, 16, 1024);
  const uint64_t dv_a = sw128_desc(smem_u32(sV) + wg * 64 * 128, 16, 1024);
  mbar_wait(kv_full, 0);

  for (int i = 0; i < nq; ++i) {
    const int s = i % ST;
    mbar_wait(&q_full[s], (i / ST) & 1);
    const uint32_t q_addr = smem_u32(sQ + s * L::TILE), g_addr = smem_u32(sG + s * L::TILE);

    // Sᵀ = K Qᵀ, dPᵀ = V dOᵀ
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t aoff = ((kk / 4) * BWD_RES * 128 + (kk % 4) * 32) >> 4;
      const uint32_t boff = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      mma_ss<64>(acc_s, dk_a + aoff, sw128_desc(q_addr + boff, 16, 1024), kk > 0);
      mma_ss<64>(acc_dp, dv_a + aoff, sw128_desc(g_addr + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);

    // Pᵀ and dSᵀ = Pᵀ∘(dPᵀ − Δ); column c is query i·64 + c
    const float* l_s = sL + 2 * BQ * s;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + 2 * ln.qd + e;
        const float lq = l_s[col], dl = l_s[BQ + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * c + 2 * r + e;
          const float p = ex2(fmaf(acc_s[x], scale_log2, -lq));
          acc_dp[x] = p * (acc_dp[x] - dl);
          acc_s[x] = p;
        }
      }
    uint32_t pa[4][4], da[4][4];
    to_a_operand<64>(acc_s, pa);
    to_a_operand<64>(acc_dp, da);

    // dV += Pᵀ dO, dK += dSᵀ Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs_mn<DP>(acc_dv, pa[kk], sw128_desc(g_addr + kk * 16 * 128, BQ * 128, 1024));
      mma_rs_mn<DP>(acc_dk, da[kk], sw128_desc(q_addr + kk * 16 * 128, BQ * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(&empty[s]);
  }

  const long long base = ((long long)b * Sk * H + h) * D;
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_rows<D>(acc_dk, mul_k, sK, BWD_RES, wg * 64, dk + base, (long long)H * D, k0 + wg * 64,
                Sk, 1 + wg, ln);
  store_rows<D>(acc_dv, mul_v, sV, BWD_RES, wg * 64, dv + base, (long long)H * D, k0 + wg * 64,
                Sk, 1 + wg, ln);
}

// (b): dQ for one (b, h, 128-query tile).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int Sq, int Sk, int H, float scale, float scale_log2) {
  using L = BwdLayout<D>;
  constexpr int DP = L::DP, ST = BWD_STAGES, BK = BWD_TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sG = smem + L::RES;             // dO
  unsigned char* sK = smem + L::STREAM;          // stage s at sK + s·TILE
  unsigned char* sV = sK + ST * L::TILE;
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* kv_full = qg_full + 1;
  uint64_t* empty = kv_full + ST;

  const int q0 = blockIdx.x * BWD_RES, h = blockIdx.y, b = blockIdx.z;
  const int nk = (Sk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qg_full, 2 * L::RES);
      load_tile<DP>(sQ, &tq, qg_full, BWD_RES, h, q0, b);
      load_tile<DP>(sG, &tg, qg_full, BWD_RES, h, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % ST, n = j / ST;
        if (n > 0) mbar_wait(&empty[s], (n - 1) & 1);
        mbar_arrive_expect_tx(&kv_full[s], 2 * L::TILE);
        load_tile<DP>(sK + s * L::TILE, &tk, &kv_full[s], BK, h, j * BK, b);
        load_tile<DP>(sV + s * L::TILE, &tv, &kv_full[s], BK, h, j * BK, b);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  float acc_dq[DP / 2], acc_s[32], acc_dp[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_s[i] = acc_dp[i] = 0.f;

  // lse·log2 e and Δ of this thread's two rows (rows past Sq are not stored)
  const int row0 = q0 + wg * 64;
  float lq[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ln.warp * 16 + ln.g + 8 * i;
    const long long at = ((long long)b * H + h) * Sq + row;
    lq[i] = row < Sq ? lse[at] * LOG2E : 0.f;
    dl[i] = row < Sq ? delta[at] : 0.f;
  }

  // A operands: this warpgroup's 64 query rows of Q and dO
  const uint64_t dq_a = sw128_desc(smem_u32(sQ) + wg * 64 * 128, 16, 1024);
  const uint64_t dg_a = sw128_desc(smem_u32(sG) + wg * 64 * 128, 16, 1024);
  mbar_wait(qg_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int s = j % ST;
    mbar_wait(&kv_full[s], (j / ST) & 1);
    const uint32_t k_addr = smem_u32(sK + s * L::TILE), v_addr = smem_u32(sV + s * L::TILE);

    // S = Q Kᵀ, dP = dO Vᵀ
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t aoff = ((kk / 4) * BWD_RES * 128 + (kk % 4) * 32) >> 4;
      const uint32_t boff = (kk / 4) * BK * 128 + (kk % 4) * 32;
      mma_ss<64>(acc_s, dq_a + aoff, sw128_desc(k_addr + boff, 16, 1024), kk > 0);
      mma_ss<64>(acc_dp, dg_a + aoff, sw128_desc(v_addr + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);

    // dS = P∘(dP − Δ); keys past Sk have P = 0
    const bool ragged = (j + 1) * BK > Sk;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      float p = ex2(fmaf(acc_s[x], scale_log2, -lq[i]));
      if (ragged && j * BK + 8 * (x / 4) + 2 * ln.qd + (x & 1) >= Sk) p = 0.f;
      acc_dp[x] = p * (acc_dp[x] - dl[i]);
    }
    uint32_t da[4][4];
    to_a_operand<64>(acc_dp, da);

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_mn<DP>(acc_dq, da[kk], sw128_desc(k_addr + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    mbar_arrive(&empty[s]);
  }

  const float mul[2] = {scale, scale};
  store_rows<D>(acc_dq, mul, sQ, BWD_RES, wg * 64, dq + ((long long)b * Sq * H + h) * D,
                (long long)H * D, row0, Sq, 1 + wg, ln);
}

// ------------------------------------------------------------------ launch

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int Sq, int Sk, int H, const long long* st, float scale, cudaStream_t stream) {
  using L = FwdLayout<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = bshd_tensor_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2], FWD_BQ)) != cudaSuccess ||
      (err = bshd_tensor_map(&tk, k, B, Sk, H, D, st[3], st[4], st[5], FWD_BK)) != cudaSuccess ||
      (err = bshd_tensor_map(&tv, v, B, Sk, H, D, st[6], st[7], st[8], FWD_BK)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, H, B);
  fa_fwd_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Sk, H, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, const long long* st,
                       float scale, cudaStream_t stream) {
  using L = BwdLayout<D>;
  // (a) streams 64-row Q/dO tiles past 128 resident keys, (b) 64-row K/V
  // tiles past 128 resident queries
  CUtensorMap aq, ak, av, ag, bq, bk, bv, bg;
  cudaError_t err;
  if ((err = bshd_tensor_map(&aq, q, B, Sq, H, D, st[0], st[1], st[2], BWD_TILE)) != cudaSuccess ||
      (err = bshd_tensor_map(&ak, k, B, Sk, H, D, st[3], st[4], st[5], BWD_RES)) != cudaSuccess ||
      (err = bshd_tensor_map(&av, v, B, Sk, H, D, st[6], st[7], st[8], BWD_RES)) != cudaSuccess ||
      (err = bshd_tensor_map(&ag, dout, B, Sq, H, D, st[12], st[13], st[14], BWD_TILE)) !=
          cudaSuccess ||
      (err = bshd_tensor_map(&bq, q, B, Sq, H, D, st[0], st[1], st[2], BWD_RES)) != cudaSuccess ||
      (err = bshd_tensor_map(&bk, k, B, Sk, H, D, st[3], st[4], st[5], BWD_TILE)) != cudaSuccess ||
      (err = bshd_tensor_map(&bv, v, B, Sk, H, D, st[6], st[7], st[8], BWD_TILE)) != cudaSuccess ||
      (err = bshd_tensor_map(&bg, dout, B, Sq, H, D, st[12], st[13], st[14], BWD_RES)) !=
          cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(fa_bwd_dkv_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)L::BYTES)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)L::BYTES)) != cudaSuccess)
    return err;
  const auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<float*>(delta);
  const long long rows = (long long)B * H * Sq;
  fa_bwd_delta_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), dp, B, Sq, H, D, st[9], st[10],
      st[11], st[12], st[13], st[14]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  fa_bwd_dkv_kernel<D><<<dim3((Sk + BWD_RES - 1) / BWD_RES, H, B), THREADS, L::BYTES, stream>>>(
      aq, ak, av, ag, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, scale,
      scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_kernel<D><<<dim3((Sq + BWD_RES - 1) / BWD_RES, H, B), THREADS, L::BYTES, stream>>>(
      bq, bk, bv, bg, lp, dp, static_cast<bf16*>(dq), Sq, Sk, H, scale, scale_log2);
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
