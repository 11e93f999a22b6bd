// Flash-attention backward: dq, and dk/dv, from the forward's logsumexp,
// without materializing the score matrix.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (flaxdiff_tpu/ops/flash_attention.py:132,
// launched at :355) and `_bwd_dkv_kernel` (:171, launched at :377), both
// driven by `_bwd_impl` (:322). As there, both kernels recompute
//   p  = exp(scale q k^T - lse)           (keys at or past kv_len give 0)
//   ds = p (dO v^T - delta) scale         (delta = rowsum(dO o), from the wrapper)
// and then dq = ds k (dq kernel), dv = p^T dO and dk = ds^T q (dk/dv kernel),
// with p and ds rounded to the input dtype before each product, as at
// flash_attention.py:162,197,203.
//
// Bound on the H100: operations. Per head the dq kernel does 3 products of
// 2 Lq Lk D flops (q k^T, dO v^T, ds k) and the dk/dv kernel 4 (k q^T,
// v dO^T, p^T dO, ds^T q), against 4-6 L D elements of traffic each: the
// five products of the backward plus the two the split recomputes. Both
// keep the JAX split, with no atomics, so the gradients are deterministic:
// a dq block per (q tile, batch*head) looping over the kv tiles, a dk/dv
// block per (kv tile, batch*head) looping over the q tiles in a fixed order.
//
// The 16-bit kernels (bf16, f16) share one design, built on hopper.cuh:
//   * one TMA producer warp and NC consumer warpgroups of 64 rows each. The
//     producer loads the block's own tiles once, then streams the other
//     side's tiles of 64 rows through a 2-stage ring (full and empty
//     mbarriers), so loads overlap the math. Operands are 4-D tensor maps
//     over (D, H, L, B) with the caller's strides, so q/k/v views of one
//     projection need no copy, and rows past lq / kv_len load as zeros;
//   * NC = 2 (128-row tiles) when those tiles give every SM a block; else
//     NC = 1, whose smaller blocks (two per SM where registers allow) fill
//     the card;
//   * the two score products are wgmma chains with both operands K-major in
//     shared memory (128-byte swizzle, 64-byte for D = 32); p and ds are
//     computed on the accumulator registers (exp2f with scale * log2(e)
//     folded in, lse in log2 units), zeroed past kv_len, rounded to the
//     input dtype in registers and fed as register-A operands of the
//     gradient products, whose B operand is read MN-major through the
//     transpose bit: scores, p and ds never touch shared memory; the
//     gradients stay in f32 registers across the loop;
//   * the epilogue writes each warpgroup's gradient rows into its own rows
//     of a consumed tile and stores them with TMA, which skips rows past
//     the end.
//
// flash_bwd_dq_wgmma_kernel (dq): a block per (q tile, batch*head). Q and dO
//   arrive once; K and V tiles stream through the ring. s = q k^T and
//   dp = dO v^T, then dq += ds k with k the B operand. A q row's lse and
//   delta are fixed for the whole loop: each consumer thread reads its two
//   rows' values once into registers (the rows are not 16-byte aligned for
//   every Lq, as a bulk copy would need), 0 past lq. D = 256 streams 32-row
//   kv tiles (DqCfg) and takes dq += ds k as two wgmma of N = 128.
//
// flash_bwd_dkv_wgmma_kernel (dk/dv): a block per (kv tile, batch*head). K
//   and V arrive once; Q and dO tiles stream through the ring, and with
//   them lse (log2 units) and delta of the tile, read by the producer's 32
//   lanes. The scores are transposed, s^T = k q^T and dp^T = v dO^T, so
//   p^T and ds^T are the A operands of dv += p^T dO and dk += ds^T q; zeroed
//   where the kv row >= kv_len or the q row >= lq. D = 128 takes one
//   consumer (its four accumulators need more registers than a block of
//   two consumers gives a thread).
//
// flash_bwd_dkv_split_wgmma_kernel (dk/dv at D = 256): two warpgroups on
//   the same 64 kv rows, each holding one column half of dk and dv and
//   computing the whole score tiles itself; no producer warp, warp 0 issues
//   the loads (DkvSplitCfg).
//
// flash_bwd_dq_fma_kernel and flash_bwd_dkv_fma_kernel (f32), chosen by an
// explicit dispatch on the dtype, keep f32 results f32-exact (the tensor
// cores would round them to TF32):
//   * the block's own tile of 4 warps x 16 rows (8 at D = 256), 64-row
//     streamed tiles, all staged through shared memory with 16-byte loads,
//     products in FMA loops (flash_common.cuh);
//   * the dk/dv kernel computes its scores transposed, k q^T and v dO^T, so a
//     warp's kv rows of p^T and ds^T are the row-major A operands of
//     p^T dO and ds^T q: no transpose anywhere;
//   * scores and dP go through a per-warp f32 scratch, where p and ds
//     overwrite them; the gradient accumulators stay in registers across
//     the loop and are written from there;
//   * q rows at or past lq and kv rows at or past kv_len (the 77-token text
//     context, ragged tiles) load as zeros and are masked out of p and ds,
//     so they add exactly 0, and no gradient row past the end is written.
// Every kernel addresses operands and gradients through explicit (batch,
// seq, head) strides, so the [B, L, H*D] projections need no transpose.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, Lq]
  const float* delta;  // [B*H, Lq]
  void* g0;            // dq, or dk
  void* g1;            // dv (dk/dv kernel)
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t do_sb, do_sl, do_sh;
  int64_t g_sb, g_sl, g_sh;  // of every gradient output
  int heads, lq, lk;
  float scale;
  int bhs;  // batch * heads
};

// Shared-memory layout: the block's two own tiles of BR = 4 RW rows (q and
// dO for dq, k and v for dk/dv), the two streamed tiles of TILE rows, then
// per warp two f32 blocks of RW x TILE (s and dP; p and ds overwrite them in
// place, element by element, in the lane that read them), then lse and delta
// of the current q tile.
template <typename T, int D>
struct Smem {
  static_assert(kIsF32<T>, "p and ds overwrite the f32 scores in place");
  static constexpr int RW = warp_rows<D>();
  static constexpr int BR = NWARPS * RW;
  static constexpr int LD_T = ld_tile<T, D>();
  static_assert(ld_p<T>() == LD_S, "p and ds share the scores' leading dimension");
  static constexpr int WARP_F32 = 2 * RW * LD_S;
  static constexpr int OWN_BYTES = align128(BR * LD_T * static_cast<int>(sizeof(T)));
  static constexpr int TILE_BYTES = align128(TILE * LD_T * static_cast<int>(sizeof(T)));
  static constexpr int OFF_STREAM = 2 * OWN_BYTES;
  static constexpr int OFF_F32 = OFF_STREAM + 2 * TILE_BYTES;
  static constexpr int OFF_ROWS = OFF_F32 + align128(NWARPS * WARP_F32 * 4);
  static constexpr int BYTES = OFF_ROWS + 2 * TILE * 4;
};

template <typename T, int D>
struct Views {
  T* own[2];     // the block's own tiles
  T* stream[2];  // the streamed tiles
  float* s;      // this warp's RW x TILE scores, then p
  float* dp;     // this warp's RW x TILE dP, then ds
  float* lse;    // [TILE] of the current q tile
  float* delta;  // [TILE]

  __device__ __forceinline__ Views(unsigned char* smem, int warp) {
    using S = Smem<T, D>;
    for (int i = 0; i < 2; ++i) {
      own[i] = reinterpret_cast<T*>(smem + i * S::OWN_BYTES);
      stream[i] = reinterpret_cast<T*>(smem + S::OFF_STREAM + i * S::TILE_BYTES);
    }
    s = reinterpret_cast<float*>(smem + S::OFF_F32) + warp * S::WARP_F32;
    dp = s + S::RW * LD_S;
    lse = reinterpret_cast<float*>(smem + S::OFF_ROWS);
    delta = lse + TILE;
  }
};

// lse and delta of the q tile at q0; rows past lq read as 0 (their
// contributions are masked anyway, this keeps them finite).
__device__ __forceinline__ void load_rows(float* lse, float* delta, const Params& p, int bh,
                                          int q0) {
  if (threadIdx.x < TILE) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < p.lq;
    const int64_t at = static_cast<int64_t>(bh) * p.lq + row;
    lse[threadIdx.x] = ok ? p.lse[at] : 0.f;
    delta[threadIdx.x] = ok ? p.delta[at] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_fma_kernel(const Params p) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_bwd_dq_wgmma_kernel");
  using S = Smem<T, D>;
  constexpr int RW = S::RW, BR = S::BR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Views<T, D> sm(smem, warp);
  T *sQ = sm.own[0], *sDO = sm.own[1], *sK = sm.stream[0], *sV = sm.stream[1];

  const int bh = split_bh();
  if (bh >= p.bhs) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * BR;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* DQ = static_cast<T*>(p.g0) + b * p.g_sb + h * p.g_sh;

  load_tile<T, D, BR>(sQ, Q, p.q_sl, q0, p.lq);
  load_tile<T, D, BR>(sDO, DO, p.do_sl, q0, p.lq);
  load_rows(sm.lse, sm.delta, p, bh, q0);

  WarpAcc<T, D> dq;
  dq.zero();
  const int n_tiles = (p.lk + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, K, p.k_sl, k0, p.lk);
    load_tile<T, D>(sV, V, p.v_sl, k0, p.lk);
    __syncthreads();

    scores<T, D>(sQ + warp * RW * S::LD_T, sK, sm.s, lane);
    scores<T, D>(sDO + warp * RW * S::LD_T, sV, sm.dp, lane);
    __syncwarp();
    for (int rr = 0; rr < RW; ++rr) {
      const float lse = sm.lse[warp * RW + rr], delta = sm.delta[warp * RW + rr];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = rr * LD_S + lane + 32 * half;
        float ds = 0.f;
        if (k0 + lane + 32 * half < p.lk) {
          const float pr = expf(sm.s[at] * p.scale - lse);
          ds = pr * (sm.dp[at] - delta) * p.scale;
        }
        sm.dp[at] = ds;
      }
    }
    __syncwarp();
    dq.add_product(sm.dp, sK, lane);
    __syncwarp();
  }
  dq.write_rows(DQ, p.g_sl, q0 + warp * RW, p.lq, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_fma_kernel(const Params p) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_bwd_dkv_wgmma_kernel");
  using S = Smem<T, D>;
  constexpr int RW = S::RW, BR = S::BR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Views<T, D> sm(smem, warp);
  T *sK = sm.own[0], *sV = sm.own[1], *sQ = sm.stream[0], *sDO = sm.stream[1];

  const int bh = split_bh();
  if (bh >= p.bhs) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int k0 = blockIdx.x * BR;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* DK = static_cast<T*>(p.g0) + b * p.g_sb + h * p.g_sh;
  T* DV = static_cast<T*>(p.g1) + b * p.g_sb + h * p.g_sh;

  load_tile<T, D, BR>(sK, K, p.k_sl, k0, p.lk);
  load_tile<T, D, BR>(sV, V, p.v_sl, k0, p.lk);

  WarpAcc<T, D> dk, dv;
  dk.zero();
  dv.zero();
  const int kv_row0 = k0 + warp * RW;
  const int n_tiles = (p.lq + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * TILE;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<T, D>(sQ, Q, p.q_sl, q0, p.lq);
    load_tile<T, D>(sDO, DO, p.do_sl, q0, p.lq);
    load_rows(sm.lse, sm.delta, p, bh, q0);
    __syncthreads();

    // transposed: row rr is kv row kv_row0 + rr, column c is q row q0 + c
    scores<T, D>(sK + warp * RW * S::LD_T, sQ, sm.s, lane);
    scores<T, D>(sV + warp * RW * S::LD_T, sDO, sm.dp, lane);
    __syncwarp();
    for (int rr = 0; rr < RW; ++rr) {
      const bool kv_ok = kv_row0 + rr < p.lk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half, at = rr * LD_S + c;
        float pr = 0.f, ds = 0.f;
        if (kv_ok && q0 + c < p.lq) {
          pr = expf(sm.s[at] * p.scale - sm.lse[c]);
          ds = pr * (sm.dp[at] - sm.delta[c]) * p.scale;
        }
        sm.s[at] = pr;
        sm.dp[at] = ds;
      }
    }
    __syncwarp();
    dv.add_product(sm.s, sDO, lane);
    dk.add_product(sm.dp, sQ, lane);
    __syncwarp();
  }
  dk.write_rows(DK, p.g_sl, kv_row0, p.lk, lane);
  dv.write_rows(DV, p.g_sl, kv_row0, p.lk, lane);
}

// --- bf16 / f16: wgmma fed by a TMA ring -------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;  // ring depth
constexpr int BQ = 64;     // q rows per tile of the dk/dv loop (D <= 128)

// The dk/dv block: K and V tiles of 64 NC rows (loaded once), STAGES (Q, dO)
// tile pairs, STAGES rows of lse (log2 units) and delta, then the mbarriers.
template <int D, int NC>
struct DkvCfg {
  static constexpr int BKV = 64 * NC;
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int MIN_BLOCKS = NC == 1 && D <= 64 ? 2 : 1;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int OFF_RING = 2 * KV_BYTES;
  static constexpr int OFF_ROWS = OFF_RING + STAGES * 2 * QT_BYTES;
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment
  static_assert(KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0, "tiles of whole swizzle atoms");
};

// The dq block: Q and dO tiles of 64 NC rows (loaded once), STAGES (K, V)
// tile pairs of BK rows, then the mbarriers. 64-row kv tiles keep s, dp and
// dq (plus ds's A fragments) within the registers a thread has up to
// D = 128; at D = 256, where dq alone is 128 registers a thread, 32-row kv
// tiles halve s and dp (16 registers each). D = 256 runs one consumer
// warpgroup (launch_dq_wgmma), one block an SM (128 KB of tiles).
template <int D, int NC>
struct DqCfg {
  static constexpr int BM = 64 * NC;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int MIN_BLOCKS = NC == 1 && D <= 128 ? 2 : 1;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_RING = 2 * Q_BYTES;
  static constexpr int OFF_BAR = OFF_RING + STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles of whole swizzle atoms");
};

struct BwdArgs {
  const float* lse;    // [B*H, Lq]
  const float* delta;  // [B*H, Lq]
  int heads, lq, lk;
  float scale, scale_log2;
  int bhs;   // batch * heads
  int bits;  // z's low bits holding the column chunk: chunk_bits(chunks)
};

// A warpgroup's 64 x N f32 accumulator, rounded to T, into rows
// row0 .. row0 + 63 and columns col0 .. col0 + N - 1 of a chunked, swizzled
// tile of `rows` rows and D columns.
template <typename T, int D, int N = D>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[N / 2], unsigned char* tile,
                                            int rows, int row0, int warp, int g, int tq,
                                            int col0 = 0) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t off = hopper::swizzled_offset<D>(rows, row0 + 16 * warp + g + 8 * j,
                                                      col0 + 8 * n + 2 * tq);
      *reinterpret_cast<uint32_t*>(tile + off) =
          hopper::pack2<T>(acc[4 * n + 2 * j], acc[4 * n + 2 * j + 1]);
    }
}

template <typename T, int D, int NC>
__global__ void __launch_bounds__(DkvCfg<D, NC>::THREADS, DkvCfg<D, NC>::MIN_BLOCKS)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mdo,
                               const __grid_constant__ CUtensorMap mdk,
                               const __grid_constant__ CUtensorMap mdv, const BwdArgs a) {
  using C = DkvCfg<D, NC>;
  using namespace hopper;
  constexpr int BKV = C::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sK = sm;
  unsigned char* sV = sm + C::KV_BYTES;
  float* rows = reinterpret_cast<float*>(sm + C::OFF_ROWS);  // per stage: lse2[BQ], delta[BQ]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int bh = split_bh();
  if (bh >= a.bhs) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int k0 = blockIdx.x * BKV;
  const int n_tiles = (a.lq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == NC) {
    // the producer warp: lane 0 issues the TMA loads, every lane loads lse
    // (in log2 units) and delta of the q tile, 0 past lq
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
      tma_load_tile<D>(sK, &mk, bar_kv, BKV, h, k0, b);
      tma_load_tile<D>(sV, &mv, bar_kv, BKV, h, k0, b);
    }
    const int64_t row_base = static_cast<int64_t>(bh) * a.lq;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES, use = t / STAGES;
      if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
      float* r = rows + st * 2 * BQ;
#pragma unroll
      for (int i = lane; i < BQ; i += 32) {
        const int row = t * BQ + i;
        const bool ok = row < a.lq;
        r[i] = ok ? a.lse[row_base + row] * LOG2E : 0.f;
        r[BQ + i] = ok ? a.delta[row_base + row] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        unsigned char* sQ = sm + C::OFF_RING + st * 2 * C::QT_BYTES;
        mbar_arrive_expect_tx(&full[st], 2 * C::QT_BYTES);
        tma_load_tile<D>(sQ, &mq, &full[st], BQ, h, t * BQ, b);
        tma_load_tile<D>(sQ + C::QT_BYTES, &mdo, &full[st], BQ, h, t * BQ, b);
      }
    }
    return;
  }

  // a consumer warpgroup: kv rows k0 + 64 wg .. + 63. Scores are transposed:
  // accumulator row = kv row, column = q row of the tile.
  const int tid = threadIdx.x % 128, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  bool kv_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) kv_ok[j] = k0 + 64 * wg + 16 * warp + g + 8 * j < a.lk;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const unsigned char* sQ = sm + C::OFF_RING + st * 2 * C::QT_BYTES;
    const unsigned char* sDO = sQ + C::QT_BYTES;
    const float* r = rows + st * 2 * BQ;
    mbar_wait(&full[st], (t / STAGES) & 1);

    // s^T = k q^T and dp^T = v dO^T, both K-major operands in shared memory
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, T>(s, desc_kmajor<D>(sK, BKV, 64 * wg, kk), desc_kmajor<D>(sQ, BQ, 0, kk),
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, T>(dp, desc_kmajor<D>(sV, BKV, 64 * wg, kk), desc_kmajor<D>(sDO, BQ, 0, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p^T = exp2(s^T scale log2e - lse2), ds^T = p^T (dp^T - delta) scale;
    // 0 where the kv row >= lk or the q row >= lq
    const bool edge = (t + 1) * BQ > a.lq;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * tq + c;
        const float lse2 = r[col], delta = r[BQ + col];
        const bool q_ok = !edge || t * BQ + col < a.lq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * j + c;
          float p = exp2f(fmaf(s[i], a.scale_log2, -lse2));
          if (!(q_ok && kv_ok[j])) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - delta) * a.scale;
        }
      }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a<T>(s, kk, pa[kk]);
      acc_to_a<T>(dp, kk, da[kk]);
    }

    // dv += p^T dO and dk += ds^T q: A from registers, B MN-major
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D, T>(dv, pa[kk], desc_mnmajor<D>(sDO, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<D, T>(dk, da[kk], desc_mnmajor<D>(sQ, BQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: dk and dv into this warpgroup's rows of the K and V tiles, then
  // TMA stores, which skip rows at or past lk
  named_barrier(1 + wg, 128);
  acc_to_tile<T, D>(dk, sK, BKV, 64 * wg, warp, g, tq);
  acc_to_tile<T, D>(dv, sV, BKV, 64 * wg, warp, g, tq);
  fence_async_smem();
  named_barrier(1 + wg, 128);
  if (tid == 0) {
    const int own = 64 * wg * chunk_row_bytes<D>();  // this warpgroup's rows in each chunk
    tma_store_tile<D>(&mdk, sK + own, BKV, h, k0 + 64 * wg, b);
    tma_store_tile<D>(&mdv, sV + own, BKV, h, k0 + 64 * wg, b);
    tma_store_wait();
  }
}

template <typename T, int D, int NC>
int launch_dkv_wgmma_nc(const Params& p, int batch, int dtype, cudaStream_t stream) {
  using C = DkvCfg<D, NC>;
  using hopper::encode_bhld;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  int r = encode_bhld<D>(&mq, p.q, dtype, batch, p.lq, p.heads, p.q_sb, p.q_sl, p.q_sh, BQ);
  if (r == 0) r = encode_bhld<D>(&mdo, p.dout, dtype, batch, p.lq, p.heads, p.do_sb, p.do_sl, p.do_sh, BQ);
  if (r == 0) r = encode_bhld<D>(&mk, p.k, dtype, batch, p.lk, p.heads, p.k_sb, p.k_sl, p.k_sh, C::BKV);
  if (r == 0) r = encode_bhld<D>(&mv, p.v, dtype, batch, p.lk, p.heads, p.v_sb, p.v_sl, p.v_sh, C::BKV);
  if (r == 0) r = encode_bhld<D>(&mdk, p.g0, dtype, batch, p.lk, p.heads, p.g_sb, p.g_sl, p.g_sh, 64);
  if (r == 0) r = encode_bhld<D>(&mdv, p.g1, dtype, batch, p.lk, p.heads, p.g_sb, p.g_sl, p.g_sh, 64);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = flash_bwd_dkv_wgmma_kernel<T, D, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs args{p.lse, p.delta, p.heads, p.lq, p.lk, p.scale, p.scale * LOG2E, p.bhs};
  dim3 grid;
  if (!split_bh_grid((p.lk + C::BKV - 1) / C::BKV, p.bhs, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mdo, mdk, mdv, args);
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv block at D = 256: 64 kv rows, whose dK and dV (64 x 256 each, in
// f32) would be 256 registers a thread in one warpgroup. Two consumer
// warpgroups split the head dim instead: warpgroup w holds dK and dV of
// columns 128 w .. 128 w + 127 (128 registers). Each computes the whole
// s^T = k q^T and dp^T = v dO^T tiles it needs over the full head dim (the
// two score products run in both warpgroups: 1.5x the block's tensor work,
// and no exchange of p or ds through shared memory or barrier inside the
// loop), on 32-row q tiles, so the scores (16 + 16 registers) fit beside the
// gradients. K and V (64 KB) arrive once; Q and dO tiles with their lse and
// delta stream through the ring. The block has no producer warp: a ninth
// warp would put three warps on one of the SM's four register files (16K
// registers each) and cap a thread at 168 registers, and the two
// accumulators alone take 128. Warp 0 issues the loads instead: the first
// two tiles before the loop, and tile t + 2 once every warp has released
// tile t's stage, so one tile is always in flight behind the math.
template <int D>
struct DkvSplitCfg {
  static constexpr int BKV = 64, BQ = 32, HALF = D / 2;
  static constexpr int THREADS = 2 * 128;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int QT_BYTES = BQ * D * 2;
  static constexpr int OFF_RING = 2 * KV_BYTES;
  static constexpr int OFF_ROWS = OFF_RING + STAGES * 2 * QT_BYTES;
  static constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment
  static_assert(HALF == 128, "two column halves of one wgmma each (N = 128)");
  static_assert(KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0, "tiles of whole swizzle atoms");
};

template <typename T, int D>
__global__ void __launch_bounds__(DkvSplitCfg<D>::THREADS, 1)
    flash_bwd_dkv_split_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                     const __grid_constant__ CUtensorMap mk,
                                     const __grid_constant__ CUtensorMap mv,
                                     const __grid_constant__ CUtensorMap mdo,
                                     const __grid_constant__ CUtensorMap mdk,
                                     const __grid_constant__ CUtensorMap mdv, const BwdArgs a) {
  using C = DkvSplitCfg<D>;
  using namespace hopper;
  constexpr int BKV = C::BKV, BQT = C::BQ, HALF = C::HALF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sK = sm;
  unsigned char* sV = sm + C::KV_BYTES;
  float* rows = reinterpret_cast<float*>(sm + C::OFF_ROWS);  // per stage: lse2[BQT], delta[BQT]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int bh = split_bh();
  if (bh >= a.bhs) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int k0 = blockIdx.x * BKV;
  const int n_tiles = (a.lq + BQT - 1) / BQT;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const bool loader = threadIdx.x < 32;  // warp 0 issues every load
  const int64_t row_base = static_cast<int64_t>(bh) * a.lq;
  // tile u into its stage: its lse (log2 units) and delta, 0 past lq, from
  // the warp's 32 lanes, then Q and dO by TMA
  auto issue = [&](int u) {
    const int st = u % STAGES;
    float* r = rows + st * 2 * BQT;
    const int row = u * BQT + lane;
    const bool ok = row < a.lq;
    r[lane] = ok ? a.lse[row_base + row] * LOG2E : 0.f;
    r[BQT + lane] = ok ? a.delta[row_base + row] : 0.f;
    __syncwarp();
    if (lane == 0) {
      unsigned char* sQ = sm + C::OFF_RING + st * 2 * C::QT_BYTES;
      mbar_arrive_expect_tx(&full[st], 2 * C::QT_BYTES);
      tma_load_tile<D>(sQ, &mq, &full[st], BQT, h, u * BQT, b);
      tma_load_tile<D>(sQ + C::QT_BYTES, &mdo, &full[st], BQT, h, u * BQT, b);
    }
  };
  if (loader) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * C::KV_BYTES);
      tma_load_tile<D>(sK, &mk, bar_kv, BKV, h, k0, b);
      tma_load_tile<D>(sV, &mv, bar_kv, BKV, h, k0, b);
    }
    for (int u = 0; u < STAGES && u < n_tiles; ++u) issue(u);
  }

  // a consumer warpgroup: all 64 kv rows, gradient columns col0 .. col0 + 127
  const int tid = threadIdx.x % 128, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const int col0 = HALF * wg;
  bool kv_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) kv_ok[j] = k0 + 16 * warp + g + 8 * j < a.lk;
  float dk[HALF / 2], dv[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const unsigned char* sQ = sm + C::OFF_RING + st * 2 * C::QT_BYTES;
    const unsigned char* sDO = sQ + C::QT_BYTES;
    const float* r = rows + st * 2 * BQT;
    mbar_wait(&full[st], (t / STAGES) & 1);

    float s[BQT / 2], dp[BQT / 2];
#pragma unroll
    for (int i = 0; i < BQT / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQT, T>(s, desc_kmajor<D>(sK, BKV, 0, kk), desc_kmajor<D>(sQ, BQT, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQT, T>(dp, desc_kmajor<D>(sV, BKV, 0, kk), desc_kmajor<D>(sDO, BQT, 0, kk),
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = (t + 1) * BQT > a.lq;
#pragma unroll
    for (int n = 0; n < BQT / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * tq + c;
        const float lse2 = r[col], delta = r[BQT + col];
        const bool q_ok = !edge || t * BQT + col < a.lq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * j + c;
          float p = exp2f(fmaf(s[i], a.scale_log2, -lse2));
          if (!(q_ok && kv_ok[j])) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - delta) * a.scale;
        }
      }
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      acc_to_a<T>(s, kk, pa[kk]);
      acc_to_a<T>(dp, kk, da[kk]);
    }

    // this warpgroup's columns: dv += p^T dO[:, col0 ..], dk += ds^T q[:, col0 ..]
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      wgmma_rs_n128<T>(dv, pa[kk], desc_mnmajor<D>(sDO, BQT, kk, col0));
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      wgmma_rs_n128<T>(dk, da[kk], desc_mnmajor<D>(sQ, BQT, kk, col0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (loader && t + STAGES < n_tiles) {
      mbar_wait(&empty[st], (t / STAGES) & 1);  // every warp is done with this stage
      issue(t + STAGES);
    }
  }

  // epilogue: once both warpgroups are done reading K and V, each writes its
  // column halves of dk and dv into them; then one thread stores both tiles
  named_barrier(1, 256);
  acc_to_tile<T, D, HALF>(dk, sK, BKV, 0, warp, g, tq, col0);
  acc_to_tile<T, D, HALF>(dv, sV, BKV, 0, warp, g, tq, col0);
  fence_async_smem();
  named_barrier(1, 256);
  if (threadIdx.x == 0) {
    tma_store_tile<D>(&mdk, sK, BKV, h, k0, b);
    tma_store_tile<D>(&mdv, sV, BKV, h, k0, b);
    tma_store_wait();
  }
}

template <typename T, int D>
int launch_dkv_split(const Params& p, int batch, int dtype, cudaStream_t stream) {
  using C = DkvSplitCfg<D>;
  using hopper::encode_bhld;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  int r = encode_bhld<D>(&mq, p.q, dtype, batch, p.lq, p.heads, p.q_sb, p.q_sl, p.q_sh, C::BQ);
  if (r == 0) r = encode_bhld<D>(&mdo, p.dout, dtype, batch, p.lq, p.heads, p.do_sb, p.do_sl, p.do_sh, C::BQ);
  if (r == 0) r = encode_bhld<D>(&mk, p.k, dtype, batch, p.lk, p.heads, p.k_sb, p.k_sl, p.k_sh, C::BKV);
  if (r == 0) r = encode_bhld<D>(&mv, p.v, dtype, batch, p.lk, p.heads, p.v_sb, p.v_sl, p.v_sh, C::BKV);
  if (r == 0) r = encode_bhld<D>(&mdk, p.g0, dtype, batch, p.lk, p.heads, p.g_sb, p.g_sl, p.g_sh, C::BKV);
  if (r == 0) r = encode_bhld<D>(&mdv, p.g1, dtype, batch, p.lk, p.heads, p.g_sb, p.g_sl, p.g_sh, C::BKV);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = flash_bwd_dkv_split_wgmma_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs args{p.lse, p.delta, p.heads, p.lq, p.lk, p.scale, p.scale * LOG2E, p.bhs};
  dim3 grid;
  if (!split_bh_grid((p.lk + C::BKV - 1) / C::BKV, p.bhs, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mdo, mdk, mdv, args);
  return static_cast<int>(cudaGetLastError());
}

// Two consumers (128-row kv tiles) when those tiles give every SM a block;
// else one. D = 128 always takes one: its four accumulators need more than
// the 168 registers a thread may hold in a block of two consumers and the
// producer warp (nine warps, three on one of the SM's four register files).
// D = 256 takes the split kernel.
template <typename T, int D>
int launch_dkv_wgmma(const Params& p, int batch, int dtype, cudaStream_t stream) {
  if constexpr (D == 256) {
    return launch_dkv_split<T, D>(p, batch, dtype, stream);
  } else {
    if constexpr (D <= 64) {
      const int64_t tiles128 = static_cast<int64_t>((p.lk + 127) / 128) * batch * p.heads;
      if (tiles128 >= sm_count()) return launch_dkv_wgmma_nc<T, D, 2>(p, batch, dtype, stream);
    }
    return launch_dkv_wgmma_nc<T, D, 1>(p, batch, dtype, stream);
  }
}

template <typename T, int D, int NC>
__global__ void __launch_bounds__(DqCfg<D, NC>::THREADS, DqCfg<D, NC>::MIN_BLOCKS)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                              const __grid_constant__ CUtensorMap mk,
                              const __grid_constant__ CUtensorMap mv,
                              const __grid_constant__ CUtensorMap mdo,
                              const __grid_constant__ CUtensorMap mdq, const BwdArgs a) {
  using C = DqCfg<D, NC>;
  using namespace hopper;
  constexpr int BM = C::BM, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sQ = sm;
  unsigned char* sDO = sm + C::OFF_DO;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int bh = split_bh();
  if (bh >= a.bhs) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (a.lk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == NC) {
    // the producer warp: one lane issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * C::Q_BYTES);
      tma_load_tile<D>(sQ, &mq, bar_q, BM, h, q0, b);
      tma_load_tile<D>(sDO, &mdo, bar_q, BM, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, use = t / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        unsigned char* sK = sm + C::OFF_RING + st * 2 * C::KV_BYTES;
        mbar_arrive_expect_tx(&full[st], 2 * C::KV_BYTES);
        tma_load_tile<D>(sK, &mk, &full[st], BK, h, t * BK, b);
        tma_load_tile<D>(sK + C::KV_BYTES, &mv, &full[st], BK, h, t * BK, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64 wg .. + 63; a thread holds rows
  // 16 warp + g and 16 warp + g + 8 of them, whose lse (log2 units) and
  // delta it reads once
  const int tid = threadIdx.x % 128, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  float lse2[2], delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * j;
    const bool ok = row < a.lq;
    const int64_t at = static_cast<int64_t>(bh) * a.lq + row;
    lse2[j] = ok ? a.lse[at] * LOG2E : 0.f;
    delta[j] = ok ? a.delta[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const unsigned char* sK = sm + C::OFF_RING + st * 2 * C::KV_BYTES;
    const unsigned char* sV = sK + C::KV_BYTES;
    mbar_wait(&full[st], (t / STAGES) & 1);

    // s = q k^T and dp = dO v^T, both K-major operands in shared memory
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK, T>(s, desc_kmajor<D>(sQ, BM, 64 * wg, kk), desc_kmajor<D>(sK, BK, 0, kk),
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK, T>(dp, desc_kmajor<D>(sDO, BM, 64 * wg, kk), desc_kmajor<D>(sV, BK, 0, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p = exp2(s scale log2e - lse2), 0 where the key >= kv_len (the zero
    // rows TMA loads there would give exp2(-lse2)); ds = p (dp - delta) scale
    const bool edge = (t + 1) * BK > a.lk;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool kv_ok = !edge || t * BK + 8 * n + 2 * tq + c < a.lk;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * j + c;
          float p = exp2f(fmaf(s[i], a.scale_log2, -lse2[j]));
          if (!kv_ok) p = 0.f;
          dp[i] = p * (dp[i] - delta[j]) * a.scale;
        }
      }
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<T>(dp, kk, da[kk]);

    // dq += ds k: A from registers, k the MN-major B operand
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_cols<D, T>(dq, da[kk], sK, BK, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: dq into this warpgroup's rows of the consumed Q tile, then a
  // TMA store, which skips rows at or past lq
  named_barrier(1 + wg, 128);
  acc_to_tile<T, D>(dq, sQ, BM, 64 * wg, warp, g, tq);
  fence_async_smem();
  named_barrier(1 + wg, 128);
  if (tid == 0) {
    tma_store_tile<D>(&mdq, sQ + 64 * wg * chunk_row_bytes<D>(), BM, h, q0 + 64 * wg, b);
    tma_store_wait();
  }
}

template <typename T, int D, int NC>
int launch_dq_wgmma_nc(const Params& p, int batch, int dtype, cudaStream_t stream) {
  using C = DqCfg<D, NC>;
  using hopper::encode_bhld;
  CUtensorMap mq, mk, mv, mdo, mdq;
  int r = encode_bhld<D>(&mq, p.q, dtype, batch, p.lq, p.heads, p.q_sb, p.q_sl, p.q_sh, C::BM);
  if (r == 0) r = encode_bhld<D>(&mdo, p.dout, dtype, batch, p.lq, p.heads, p.do_sb, p.do_sl, p.do_sh, C::BM);
  if (r == 0) r = encode_bhld<D>(&mk, p.k, dtype, batch, p.lk, p.heads, p.k_sb, p.k_sl, p.k_sh, C::BK);
  if (r == 0) r = encode_bhld<D>(&mv, p.v, dtype, batch, p.lk, p.heads, p.v_sb, p.v_sl, p.v_sh, C::BK);
  if (r == 0) r = encode_bhld<D>(&mdq, p.g0, dtype, batch, p.lq, p.heads, p.g_sb, p.g_sl, p.g_sh, 64);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = flash_bwd_dq_wgmma_kernel<T, D, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs args{p.lse, p.delta, p.heads, p.lq, p.lk, p.scale, p.scale * LOG2E, p.bhs};
  dim3 grid;
  if (!split_bh_grid((p.lq + C::BM - 1) / C::BM, p.bhs, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mdo, mdq, args);
  return static_cast<int>(cudaGetLastError());
}

// Two consumers (128-row q tiles) when those tiles give every SM a block;
// else one, whose blocks are half the size and twice as many. D = 256 always
// takes one: a block of two consumers and the producer warp is nine warps,
// three of them on one of the SM's four register files, which caps a thread
// at 168 registers; dq alone is 128 there.
template <typename T, int D>
int launch_dq_wgmma(const Params& p, int batch, int dtype, cudaStream_t stream) {
  if constexpr (D <= 128) {
    const int64_t tiles128 = static_cast<int64_t>((p.lq + 127) / 128) * batch * p.heads;
    if (tiles128 >= sm_count()) return launch_dq_wgmma_nc<T, D, 2>(p, batch, dtype, stream);
  }
  return launch_dq_wgmma_nc<T, D, 1>(p, batch, dtype, stream);
}

template <typename T, int D>
int launch_fma(void (*kernel)(const Params), const Params& p, int rows, int batch,
               cudaStream_t stream) {
  using S = Smem<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  if (!split_bh_grid((rows + S::BR - 1) / S::BR, p.bhs, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, NTHREADS, S::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 takes the FMA kernels, bf16 and f16 the wgmma kernels: a dispatch on
// the dtype, with no fallback from one to the other.
template <typename T, int D>
int launch(const Params& p, int batch, int dtype, bool dq, cudaStream_t stream) {
  if constexpr (kIsF32<T>) {
    if (dq) return launch_fma<T, D>(flash_bwd_dq_fma_kernel<T, D>, p, p.lq, batch, stream);
    return launch_fma<T, D>(flash_bwd_dkv_fma_kernel<T, D>, p, p.lk, batch, stream);
  } else {
    if (dq) return launch_dq_wgmma<T, D>(p, batch, dtype, stream);
    return launch_dkv_wgmma<T, D>(p, batch, dtype, stream);
  }
}

template <typename T>
int dispatch_d(const Params& p, int batch, int d, int dtype, bool dq, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, dtype, dq, stream);
    case 64: return launch<T, 64>(p, batch, dtype, dq, stream);
    case 128: return launch<T, 128>(p, batch, dtype, dq, stream);
    case 256: return launch<T, 256>(p, batch, dtype, dq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Params& p, int batch, int d, int dtype, bool dq, void* stream) {
  if (p.lq <= 0 || p.lk <= 0 || batch <= 0 || p.heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_d<float>(p, batch, d, dtype, dq, s);
    case kBFloat16: return dispatch_d<__nv_bfloat16>(p, batch, d, dtype, dq, s);
    case kFloat16: return dispatch_d<__half>(p, batch, d, dtype, dq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- head dims above 256: the column-chunked (wide) kernels -------------------
//
// Also replace `_bwd_dq_kernel` (flash_attention.py:132) and
// `_bwd_dkv_kernel` (:171) at head dims the reference pads to a multiple of
// 128. As in flash_fwd.cu's wide forward, a 64-row f32 gradient of D > 256
// columns does not fit one warpgroup, so the grid gets a third dimension
// over column chunks of the gradients (WIDE_COLS_16 = 128 columns for
// bf16/f16, WIDE_COLS_F32 = 64 for f32). Every block recomputes both score
// tiles, s = q k^T and dp = dO v^T (transposed for dk/dv), over the full head
// dim, summed WIDE_CHUNK = 64 columns at a time through shared memory, then
// p and ds as the D <= 256 kernels do, and keeps only its own columns of dq,
// or of dk and dv. Nothing in shared memory has the head dim as a dimension.
// The same split as there (a dq block per q tile, a dk/dv block per kv tile,
// fixed loop orders, no atomics): the gradients are deterministic.
//
// flash_bwd_dq_wide_wgmma_kernel / flash_bwd_dkv_wide_wgmma_kernel (bf16,
// f16): one warpgroup; q, k, dO and v chunks stream through a 2-stage TMA
// ring, thread 0 issuing chunk u + 2 once every warp has read chunk u; the
// tile the gradient product reads (k's columns for dq; q's and dO's for
// dk/dv) arrives on its own barrier. dk/dv takes 32-row q tiles, so its
// scores (16 + 16 registers) fit beside dk and dv (64 + 64).
//
// flash_bwd_dq_wide_fma_kernel / flash_bwd_dkv_wide_fma_kernel (f32): the
// D = 64 FMA kernels with their tiles loaded 64 columns at a time, the
// scores summed across them, and the gradient product's tile the block's 64
// columns.

struct WideBwdCfg {
  static constexpr int B_OWN = 64;   // rows of the block's own tile (q for dq, kv for dk/dv)
  static constexpr int BK_DQ = 64;   // kv rows a tile of the dq loop
  static constexpr int BQ_DKV = 32;  // q rows a tile of the dk/dv loop
  static constexpr int W = WIDE_COLS_16, CH = WIDE_CHUNK;
  static constexpr int THREADS = 128;
  static constexpr int ROW_BYTES = CH * 2;  // one row of a 64-column chunk
};

struct WideBwdArgs {
  const float* lse;    // [B*H, Lq]
  const float* delta;  // [B*H, Lq]
  int heads, lq, lk, d;
  float scale, scale_log2;
  int bhs;   // batch * heads
  int bits;  // z's low bits holding the column chunk: chunk_bits(chunks)
};

template <typename T>
__global__ void __launch_bounds__(WideBwdCfg::THREADS)
    flash_bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                   const __grid_constant__ CUtensorMap mk,
                                   const __grid_constant__ CUtensorMap mv,
                                   const __grid_constant__ CUtensorMap mdo,
                                   const __grid_constant__ CUtensorMap mdq, const WideBwdArgs a) {
  using C = WideBwdCfg;
  using namespace hopper;
  constexpr int BM = C::B_OWN, BK = C::BK_DQ, W = C::W, CH = C::CH;
  // a stage: chunks of q [BM], k [BK], dO [BM], v [BK]; then k's W columns [BK]
  constexpr int Q_BYTES = BM * C::ROW_BYTES, K_BYTES = BK * C::ROW_BYTES;
  constexpr int STAGE_BYTES = 2 * Q_BYTES + 2 * K_BYTES;
  constexpr int OFF_KW = STAGES * STAGE_BYTES;
  constexpr int OFF_BAR = OFF_KW + BK * W * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sKw = sm + OFF_KW;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t* bar_w = full + STAGES;

  const int chunks = (a.d + W - 1) / W, chunk = split_chunk(a.bits);
  const int bh = split_bh(a.bits);
  if (bh >= a.bhs || chunk >= chunks) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * BM, col0 = chunk * W;
  const int nd = a.d / CH;
  const int n_tiles = (a.lk + BK - 1) / BK;
  const int total = n_tiles * nd;
  const int wboxes = col0 + CH < a.d ? 2 : 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(bar_w, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto issue = [&](int u) {
    const int st = u % STAGES, t = u / nd, c = (u - t * nd) * CH;
    unsigned char* s = sm + st * STAGE_BYTES;
    mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
    tma_load_4d(s, &mq, &full[st], c, h, q0, b);
    tma_load_4d(s + Q_BYTES, &mk, &full[st], c, h, t * BK, b);
    tma_load_4d(s + Q_BYTES + K_BYTES, &mdo, &full[st], c, h, q0, b);
    tma_load_4d(s + 2 * Q_BYTES + K_BYTES, &mv, &full[st], c, h, t * BK, b);
  };
  auto issue_w = [&](int t) {
    mbar_arrive_expect_tx(bar_w, wboxes * K_BYTES);
    for (int j = 0; j < wboxes; ++j)
      tma_load_4d(sKw + j * K_BYTES, &mk, bar_w, col0 + j * CH, h, t * BK, b);
  };
  if (tid == 0) {
    for (int u = 0; u < STAGES && u < total; ++u) issue(u);
    issue_w(0);
  }

  // a thread holds rows 16 warp + g and 16 warp + g + 8 of the q tile
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  float lse2[2], delta[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + 16 * warp + g + 8 * j;
    const bool ok = row < a.lq;
    const int64_t at = static_cast<int64_t>(bh) * a.lq + row;
    lse2[j] = ok ? a.lse[at] * LOG2E : 0.f;
    delta[j] = ok ? a.delta[at] : 0.f;
  }
  float dq[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dq[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < nd; ++c) {
      const int u = t * nd + c, st = u % STAGES;
      const unsigned char* sQ = sm + st * STAGE_BYTES;
      const unsigned char* sK = sQ + Q_BYTES;
      const unsigned char* sDO = sK + K_BYTES;
      const unsigned char* sV = sDO + Q_BYTES;
      mbar_wait(&full[st], (u / STAGES) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma_ss<BK, T>(s, desc_kmajor<CH>(sQ, BM, 0, kk), desc_kmajor<CH>(sK, BK, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma_ss<BK, T>(dp, desc_kmajor<CH>(sDO, BM, 0, kk), desc_kmajor<CH>(sV, BK, 0, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      __syncthreads();  // every warp is done reading stage st
      if (tid == 0 && u + STAGES < total) issue(u + STAGES);
    }

    // p and ds as the D <= 256 kernel computes them
    const bool edge = (t + 1) * BK > a.lk;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const bool kv_ok = !edge || t * BK + 8 * n + 2 * tq + cc < a.lk;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * j + cc;
          float p = exp2f(fmaf(s[i], a.scale_log2, -lse2[j]));
          if (!kv_ok) p = 0.f;
          dp[i] = p * (dp[i] - delta[j]) * a.scale;
        }
      }
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<T>(dp, kk, da[kk]);

    // dq += ds k[:, col0 ..]: A from registers, k's columns MN-major
    mbar_wait(bar_w, t & 1);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<W, T>(dq, da[kk], desc_mnmajor<W>(sKw, BK, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncthreads();  // every warp is done reading k's columns
    if (tid == 0 && t + 1 < n_tiles) issue_w(t + 1);
  }

  // epilogue: dq into the consumed column tile, then TMA stores of the
  // block's boxes, which skip rows at or past lq
  acc_to_tile<T, W>(dq, sKw, BM, 0, warp, g, tq);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < wboxes; ++j)
      tma_store_4d(&mdq, sKw + j * BM * C::ROW_BYTES, col0 + j * CH, h, q0, b);
    tma_store_wait();
  }
}

template <typename T>
__global__ void __launch_bounds__(WideBwdCfg::THREADS)
    flash_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                    const __grid_constant__ CUtensorMap mk,
                                    const __grid_constant__ CUtensorMap mv,
                                    const __grid_constant__ CUtensorMap mdo,
                                    const __grid_constant__ CUtensorMap mdk,
                                    const __grid_constant__ CUtensorMap mdv, const WideBwdArgs a) {
  using C = WideBwdCfg;
  using namespace hopper;
  constexpr int BKV = C::B_OWN, BQT = C::BQ_DKV, W = C::W, CH = C::CH;
  // a stage: chunks of k [BKV], v [BKV], q [BQT], dO [BQT]; then q's and dO's
  // W columns [BQT]
  constexpr int KV_BYTES = BKV * C::ROW_BYTES, QT_BYTES = BQT * C::ROW_BYTES;
  constexpr int STAGE_BYTES = 2 * KV_BYTES + 2 * QT_BYTES;
  constexpr int OFF_QW = STAGES * STAGE_BYTES;
  constexpr int OFF_DOW = OFF_QW + BQT * W * 2;
  constexpr int OFF_BAR = OFF_DOW + BQT * W * 2;
  static_assert(OFF_QW >= 2 * BKV * W * 2, "the ring holds the dk and dv tiles of the epilogue");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sQw = sm + OFF_QW;
  unsigned char* sDOw = sm + OFF_DOW;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t* bar_w = full + STAGES;

  const int chunks = (a.d + W - 1) / W, chunk = split_chunk(a.bits);
  const int bh = split_bh(a.bits);
  if (bh >= a.bhs || chunk >= chunks) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int k0 = blockIdx.x * BKV, col0 = chunk * W;
  const int nd = a.d / CH;
  const int n_tiles = (a.lq + BQT - 1) / BQT;
  const int total = n_tiles * nd;
  const int wboxes = col0 + CH < a.d ? 2 : 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(bar_w, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto issue = [&](int u) {
    const int st = u % STAGES, t = u / nd, c = (u - t * nd) * CH;
    unsigned char* s = sm + st * STAGE_BYTES;
    mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
    tma_load_4d(s, &mk, &full[st], c, h, k0, b);
    tma_load_4d(s + KV_BYTES, &mv, &full[st], c, h, k0, b);
    tma_load_4d(s + 2 * KV_BYTES, &mq, &full[st], c, h, t * BQT, b);
    tma_load_4d(s + 2 * KV_BYTES + QT_BYTES, &mdo, &full[st], c, h, t * BQT, b);
  };
  auto issue_w = [&](int t) {
    mbar_arrive_expect_tx(bar_w, 2 * wboxes * QT_BYTES);
    for (int j = 0; j < wboxes; ++j) {
      tma_load_4d(sQw + j * QT_BYTES, &mq, bar_w, col0 + j * CH, h, t * BQT, b);
      tma_load_4d(sDOw + j * QT_BYTES, &mdo, bar_w, col0 + j * CH, h, t * BQT, b);
    }
  };
  if (tid == 0) {
    for (int u = 0; u < STAGES && u < total; ++u) issue(u);
    issue_w(0);
  }

  // scores transposed: accumulator row = kv row, column = q row of the tile
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  bool kv_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) kv_ok[j] = k0 + 16 * warp + g + 8 * j < a.lk;
  float dk[W / 2], dv[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) dk[i] = dv[i] = 0.f;

  const int64_t row_base = static_cast<int64_t>(bh) * a.lq;
  for (int t = 0; t < n_tiles; ++t) {
    // lse (log2 units) and delta of this thread's q columns, 0 past lq,
    // read while the tile's score chunks arrive
    float lse2[BQT / 4], dlt[BQT / 4];
#pragma unroll
    for (int n = 0; n < BQT / 8; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int row = t * BQT + 8 * n + 2 * tq + cc;
        const bool ok = row < a.lq;
        lse2[2 * n + cc] = ok ? a.lse[row_base + row] * LOG2E : 0.f;
        dlt[2 * n + cc] = ok ? a.delta[row_base + row] : 0.f;
      }
    float s[BQT / 2], dp[BQT / 2];
#pragma unroll
    for (int i = 0; i < BQT / 2; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < nd; ++c) {
      const int u = t * nd + c, st = u % STAGES;
      const unsigned char* sK = sm + st * STAGE_BYTES;
      const unsigned char* sV = sK + KV_BYTES;
      const unsigned char* sQ = sV + KV_BYTES;
      const unsigned char* sDO = sQ + QT_BYTES;
      mbar_wait(&full[st], (u / STAGES) & 1);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma_ss<BQT, T>(s, desc_kmajor<CH>(sK, BKV, 0, kk), desc_kmajor<CH>(sQ, BQT, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma_ss<BQT, T>(dp, desc_kmajor<CH>(sV, BKV, 0, kk), desc_kmajor<CH>(sDO, BQT, 0, kk),
                         1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      __syncthreads();  // every warp is done reading stage st
      if (tid == 0 && u + STAGES < total) issue(u + STAGES);
    }

    // p^T and ds^T as the D <= 256 kernel computes them
    const bool edge = (t + 1) * BQT > a.lq;
#pragma unroll
    for (int n = 0; n < BQT / 8; ++n)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * n + 2 * tq + cc;
        const bool q_ok = !edge || t * BQT + col < a.lq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 4 * n + 2 * j + cc;
          float p = exp2f(fmaf(s[i], a.scale_log2, -lse2[2 * n + cc]));
          if (!(q_ok && kv_ok[j])) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dlt[2 * n + cc]) * a.scale;
        }
      }
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      acc_to_a<T>(s, kk, pa[kk]);
      acc_to_a<T>(dp, kk, da[kk]);
    }

    // dv += p^T dO[:, col0 ..] and dk += ds^T q[:, col0 ..]
    mbar_wait(bar_w, t & 1);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      wgmma_rs<W, T>(dv, pa[kk], desc_mnmajor<W>(sDOw, BQT, kk));
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
      wgmma_rs<W, T>(dk, da[kk], desc_mnmajor<W>(sQw, BQT, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every warp is done reading the column tiles
    if (tid == 0 && t + 1 < n_tiles) issue_w(t + 1);
  }

  // epilogue: dk and dv into the (idle) ring, then TMA stores of the block's
  // boxes, which skip rows at or past lk
  unsigned char* sDK = sm;
  unsigned char* sDV = sm + BKV * W * 2;
  acc_to_tile<T, W>(dk, sDK, BKV, 0, warp, g, tq);
  acc_to_tile<T, W>(dv, sDV, BKV, 0, warp, g, tq);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < wboxes; ++j) {
      tma_store_4d(&mdk, sDK + j * BKV * C::ROW_BYTES, col0 + j * CH, h, k0, b);
      tma_store_4d(&mdv, sDV + j * BKV * C::ROW_BYTES, col0 + j * CH, h, k0, b);
    }
    tma_store_wait();
  }
}

template <typename T>
int launch_wide_wgmma(const Params& p, const WideBwdArgs& args, int batch, int dtype, bool dq,
                      cudaStream_t stream) {
  using C = WideBwdCfg;
  using hopper::encode_bhld_wide;
  const int d = args.d;
  // q-side maps in boxes of the q rows a tile of the kernel takes
  const int q_rows = dq ? C::B_OWN : C::BQ_DKV, kv_rows = dq ? C::BK_DQ : C::B_OWN;
  CUtensorMap mq, mk, mv, mdo, mg0, mg1;
  const int g_len = dq ? p.lq : p.lk, g_rows = C::B_OWN;
  int r = encode_bhld_wide(&mq, p.q, dtype, batch, p.lq, p.heads, d, p.q_sb, p.q_sl, p.q_sh, q_rows);
  if (r == 0) r = encode_bhld_wide(&mdo, p.dout, dtype, batch, p.lq, p.heads, d, p.do_sb, p.do_sl, p.do_sh, q_rows);
  if (r == 0) r = encode_bhld_wide(&mk, p.k, dtype, batch, p.lk, p.heads, d, p.k_sb, p.k_sl, p.k_sh, kv_rows);
  if (r == 0) r = encode_bhld_wide(&mv, p.v, dtype, batch, p.lk, p.heads, d, p.v_sb, p.v_sl, p.v_sh, kv_rows);
  if (r == 0) r = encode_bhld_wide(&mg0, p.g0, dtype, batch, g_len, p.heads, d, p.g_sb, p.g_sl, p.g_sh, g_rows);
  if (r == 0 && !dq) r = encode_bhld_wide(&mg1, p.g1, dtype, batch, g_len, p.heads, d, p.g_sb, p.g_sl, p.g_sh, g_rows);
  if (r != 0) return hopper::kTensorMapError + r;
  constexpr int RING_DQ = STAGES * (2 * C::B_OWN + 2 * C::BK_DQ) * C::ROW_BYTES;
  constexpr int RING_DKV = STAGES * (2 * C::B_OWN + 2 * C::BQ_DKV) * C::ROW_BYTES;
  const int bytes = dq ? RING_DQ + C::BK_DQ * C::W * 2 + 8 * (STAGES + 1) + 1024
                       : RING_DKV + 2 * C::BQ_DKV * C::W * 2 + 8 * (STAGES + 1) + 1024;
  const int chunks = (d + C::W - 1) / C::W;
  dim3 grid;
  if (!split_bh_grid((g_len + C::B_OWN - 1) / C::B_OWN, p.bhs, chunks, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  WideBwdArgs a = args;
  a.bits = chunk_bits(chunks);
  cudaError_t err;
  if (dq) {
    auto kernel = flash_bwd_dq_wide_wgmma_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, C::THREADS, bytes, stream>>>(mq, mk, mv, mdo, mg0, a);
  } else {
    auto kernel = flash_bwd_dkv_wide_wgmma_kernel<T>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, C::THREADS, bytes, stream>>>(mq, mk, mv, mdo, mg0, mg1, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_wide_fma_kernel(const Params p, int d,
                                                                         int bits) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_bwd_dq_wide_wgmma_kernel");
  constexpr int D = WIDE_CHUNK;  // the tiles' columns: a score chunk, or the block's dq
  using S = Smem<T, D>;
  constexpr int RW = S::RW, BR = S::BR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Views<T, D> sm(smem, warp);
  T *sQ = sm.own[0], *sDO = sm.own[1], *sK = sm.stream[0], *sV = sm.stream[1];

  const int chunks = d / WIDE_COLS_F32, chunk = split_chunk(bits);
  const int bh = split_bh(bits);
  if (bh >= p.bhs || chunk >= chunks) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * BR, col0 = chunk * WIDE_COLS_F32;
  const int nd = d / D;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* DQ = static_cast<T*>(p.g0) + b * p.g_sb + h * p.g_sh + col0;

  load_rows(sm.lse, sm.delta, p, bh, q0);
  WarpAcc<T, D> dq;
  dq.zero();
  const int n_tiles = (p.lk + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    for (int c = 0; c < nd; ++c) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<T, D, BR>(sQ, Q + c * D, p.q_sl, q0, p.lq);
      load_tile<T, D, BR>(sDO, DO + c * D, p.do_sl, q0, p.lq);
      load_tile<T, D>(sK, K + c * D, p.k_sl, k0, p.lk);
      load_tile<T, D>(sV, V + c * D, p.v_sl, k0, p.lk);
      __syncthreads();
      scores<T, D>(sQ + warp * RW * S::LD_T, sK, sm.s, lane, c > 0);
      scores<T, D>(sDO + warp * RW * S::LD_T, sV, sm.dp, lane, c > 0);
    }
    __syncwarp();
    for (int rr = 0; rr < RW; ++rr) {
      const float lse = sm.lse[warp * RW + rr], delta = sm.delta[warp * RW + rr];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = rr * LD_S + lane + 32 * half;
        float ds = 0.f;
        if (k0 + lane + 32 * half < p.lk) {
          const float pr = expf(sm.s[at] * p.scale - lse);
          ds = pr * (sm.dp[at] - delta) * p.scale;
        }
        sm.dp[at] = ds;
      }
    }
    __syncthreads();  // every warp is done with the last k chunk
    load_tile<T, D>(sK, K + col0, p.k_sl, k0, p.lk);
    __syncthreads();
    dq.add_product(sm.dp, sK, lane);
  }
  dq.write_rows(DQ, p.g_sl, q0 + warp * RW, p.lq, lane);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_wide_fma_kernel(const Params p, int d,
                                                                          int bits) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_bwd_dkv_wide_wgmma_kernel");
  constexpr int D = WIDE_CHUNK;
  using S = Smem<T, D>;
  constexpr int RW = S::RW, BR = S::BR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Views<T, D> sm(smem, warp);
  T *sK = sm.own[0], *sV = sm.own[1], *sQ = sm.stream[0], *sDO = sm.stream[1];

  const int chunks = d / WIDE_COLS_F32, chunk = split_chunk(bits);
  const int bh = split_bh(bits);
  if (bh >= p.bhs || chunk >= chunks) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int k0 = blockIdx.x * BR, col0 = chunk * WIDE_COLS_F32;
  const int nd = d / D;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* DK = static_cast<T*>(p.g0) + b * p.g_sb + h * p.g_sh + col0;
  T* DV = static_cast<T*>(p.g1) + b * p.g_sb + h * p.g_sh + col0;

  WarpAcc<T, D> dk, dv;
  dk.zero();
  dv.zero();
  const int kv_row0 = k0 + warp * RW;
  const int n_tiles = (p.lq + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * TILE;
    for (int c = 0; c < nd; ++c) {
      __syncthreads();  // every warp is done with the previous tiles
      load_tile<T, D, BR>(sK, K + c * D, p.k_sl, k0, p.lk);
      load_tile<T, D, BR>(sV, V + c * D, p.v_sl, k0, p.lk);
      load_tile<T, D>(sQ, Q + c * D, p.q_sl, q0, p.lq);
      load_tile<T, D>(sDO, DO + c * D, p.do_sl, q0, p.lq);
      if (c == 0) load_rows(sm.lse, sm.delta, p, bh, q0);
      __syncthreads();
      // transposed: row rr is kv row kv_row0 + rr, column is q row q0 + column
      scores<T, D>(sK + warp * RW * S::LD_T, sQ, sm.s, lane, c > 0);
      scores<T, D>(sV + warp * RW * S::LD_T, sDO, sm.dp, lane, c > 0);
    }
    __syncwarp();
    for (int rr = 0; rr < RW; ++rr) {
      const bool kv_ok = kv_row0 + rr < p.lk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = lane + 32 * half, at = rr * LD_S + col;
        float pr = 0.f, ds = 0.f;
        if (kv_ok && q0 + col < p.lq) {
          pr = expf(sm.s[at] * p.scale - sm.lse[col]);
          ds = pr * (sm.dp[at] - sm.delta[col]) * p.scale;
        }
        sm.s[at] = pr;
        sm.dp[at] = ds;
      }
    }
    __syncthreads();  // every warp is done with the last q and dO chunks
    load_tile<T, D>(sQ, Q + col0, p.q_sl, q0, p.lq);
    load_tile<T, D>(sDO, DO + col0, p.do_sl, q0, p.lq);
    __syncthreads();
    dv.add_product(sm.s, sDO, lane);
    dk.add_product(sm.dp, sQ, lane);
  }
  dk.write_rows(DK, p.g_sl, kv_row0, p.lk, lane);
  dv.write_rows(DV, p.g_sl, kv_row0, p.lk, lane);
}

int dispatch_wide(const Params& p, int batch, int d, int dtype, bool dq, void* stream) {
  if (p.lq <= 0 || p.lk <= 0 || batch <= 0 || p.heads <= 0 || d < WIDE_MIN_D ||
      d % WIDE_CHUNK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WideBwdArgs args{p.lse, p.delta, p.heads, p.lq, p.lk, d, p.scale, p.scale * LOG2E,
                           p.bhs, 0};
  switch (dtype) {
    case kFloat32: {
      using S = Smem<float, WIDE_CHUNK>;
      auto kernel = dq ? flash_bwd_dq_wide_fma_kernel<float> : flash_bwd_dkv_wide_fma_kernel<float>;
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int chunks = d / WIDE_COLS_F32;
      dim3 grid;
      if (!split_bh_grid(((dq ? p.lq : p.lk) + S::BR - 1) / S::BR, p.bhs, chunks, &grid))
        return static_cast<int>(cudaErrorInvalidConfiguration);
      kernel<<<grid, NTHREADS, S::BYTES, s>>>(p, d, chunk_bits(chunks));
      return static_cast<int>(cudaGetLastError());
    }
    case kBFloat16: return launch_wide_wgmma<__nv_bfloat16>(p, args, batch, dtype, dq, s);
    case kFloat16: return launch_wide_wgmma<__half>(p, args, batch, dtype, dq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int64_t q_sb,
                            int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
                            int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t do_sb,
                            int64_t do_sl, int64_t do_sh, int64_t g_sb, int64_t g_sl,
                            int64_t g_sh, int batch, int heads, int lq, int lk, int d,
                            float scale, int dtype, void* stream) {
  const Params p{q,    k,    v,    dout, lse,   delta, dq,   nullptr, q_sb,  q_sl,
                 q_sh, k_sb, k_sl, k_sh, v_sb,  v_sl,  v_sh, do_sb,   do_sl, do_sh,
                 g_sb, g_sl, g_sh, heads, lq,   lk,    scale, batch * heads};
  return dispatch(p, batch, d, dtype, true, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
                             int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
                             int64_t v_sh, int64_t do_sb, int64_t do_sl, int64_t do_sh,
                             int64_t g_sb, int64_t g_sl, int64_t g_sh, int batch, int heads,
                             int lq, int lk, int d, float scale, int dtype, void* stream) {
  const Params p{q,    k,    v,    dout, lse,   delta, dk,   dv,    q_sb,  q_sl,
                 q_sh, k_sb, k_sl, k_sh, v_sb,  v_sl,  v_sh, do_sb, do_sl, do_sh,
                 g_sb, g_sl, g_sh, heads, lq,   lk,    scale, batch * heads};
  return dispatch(p, batch, d, dtype, false, stream);
}

// Head dims above 256, a multiple of 64 (the wide kernels): the same
// arguments as flash_bwd_dq and flash_bwd_dkv.
extern "C" int flash_bwd_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int64_t q_sb,
                                 int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
                                 int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,
                                 int64_t do_sb, int64_t do_sl, int64_t do_sh, int64_t g_sb,
                                 int64_t g_sl, int64_t g_sh, int batch, int heads, int lq, int lk,
                                 int d, float scale, int dtype, void* stream) {
  const Params p{q,    k,    v,    dout, lse,   delta, dq,   nullptr, q_sb,  q_sl,
                 q_sh, k_sb, k_sl, k_sh, v_sb,  v_sl,  v_sh, do_sb,   do_sl, do_sh,
                 g_sb, g_sl, g_sh, heads, lq,   lk,    scale, batch * heads};
  return dispatch_wide(p, batch, d, dtype, true, stream);
}

extern "C" int flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
                                  int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
                                  int64_t v_sh, int64_t do_sb, int64_t do_sl, int64_t do_sh,
                                  int64_t g_sb, int64_t g_sl, int64_t g_sh, int batch, int heads,
                                  int lq, int lk, int d, float scale, int dtype, void* stream) {
  const Params p{q,    k,    v,    dout, lse,   delta, dk,   dv,    q_sb,  q_sl,
                 q_sh, k_sb, k_sl, k_sh, v_sb,  v_sl,  v_sh, do_sb, do_sl, do_sh,
                 g_sb, g_sl, g_sh, heads, lq,   lk,    scale, batch * heads};
  return dispatch_wide(p, batch, d, dtype, false, stream);
}
