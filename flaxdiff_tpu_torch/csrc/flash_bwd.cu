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
//   every Lq, as a bulk copy would need), 0 past lq.
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
// flash_bwd_dq_fma_kernel and flash_bwd_dkv_fma_kernel (f32), chosen by an
// explicit dispatch on the dtype, keep f32 results f32-exact (the tensor
// cores would round them to TF32):
//   * 64-row tiles, 4 warps of 16 rows, tiles staged through shared memory
//     with 16-byte loads, products in FMA loops (flash_common.cuh);
//   * the dk/dv kernel computes its scores transposed, k q^T and v dO^T, so a
//     warp's 16 kv rows of p^T and ds^T are the row-major A operands of
//     p^T dO and ds^T q: no transpose anywhere;
//   * scores and dP go through a per-warp f32 scratch, p and ds through a
//     per-warp buffer; the 16 x D gradient accumulators stay in registers
//     across the loop;
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
};

// Shared-memory layout: four tiles, then per warp two f32 score blocks
// (which hold the warp's 16 x D result at the end) and two blocks of p / ds
// in T, then lse and delta of the current q tile.
template <typename T, int D>
struct Smem {
  static constexpr int LD_T = ld_tile<T, D>();
  static constexpr int LD_P = ld_p<T>();
  static constexpr int LD_O = D + 4;
  static constexpr int WARP_F32 = 2 * 16 * LD_S;
  static_assert(16 * LD_O <= WARP_F32, "a warp's result fits its score blocks");
  static constexpr int TILE_BYTES = align128(TILE * LD_T * static_cast<int>(sizeof(T)));
  static constexpr int OFF_F32 = 4 * TILE_BYTES;
  static constexpr int OFF_P = OFF_F32 + align128(NWARPS * WARP_F32 * 4);
  static constexpr int OFF_ROWS =
      OFF_P + align128(NWARPS * 2 * 16 * LD_P * static_cast<int>(sizeof(T)));
  static constexpr int BYTES = OFF_ROWS + 2 * TILE * 4;
};

template <typename T, int D>
struct Views {
  T* tile[4];
  float* s;      // this warp's 16 x TILE scores
  float* dp;     // this warp's 16 x TILE dP
  T* p;          // this warp's 16 x TILE p, in T
  T* ds;         // this warp's 16 x TILE ds, in T
  float* lse;    // [TILE] of the current q tile
  float* delta;  // [TILE]

  __device__ __forceinline__ Views(unsigned char* smem, int warp) {
    using S = Smem<T, D>;
    for (int i = 0; i < 4; ++i) tile[i] = reinterpret_cast<T*>(smem + i * S::TILE_BYTES);
    s = reinterpret_cast<float*>(smem + S::OFF_F32) + warp * S::WARP_F32;
    dp = s + 16 * LD_S;
    p = reinterpret_cast<T*>(smem + S::OFF_P) + warp * 2 * 16 * S::LD_P;
    ds = p + 16 * S::LD_P;
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

// The warp's 16 x D result (in its f32 blocks, leading dimension LD_O) to
// rows row0 .. row0 + 15 of out, those below rows_total.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* out, int64_t stride_l, const float* res, int row0,
                                           int rows_total, int lane) {
  constexpr int LD_O = Smem<T, D>::LD_O;
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, col = e - rr * D;
    if (row0 + rr < rows_total) out[(row0 + rr) * stride_l + col] = from_f32<T>(res[rr * LD_O + col]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_fma_kernel(const Params p) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_bwd_dq_wgmma_kernel");
  using S = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Views<T, D> sm(smem, warp);
  T *sQ = sm.tile[0], *sDO = sm.tile[1], *sK = sm.tile[2], *sV = sm.tile[3];

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * TILE;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* DQ = static_cast<T*>(p.g0) + b * p.g_sb + h * p.g_sh;

  load_tile<T, D>(sQ, Q, p.q_sl, q0, p.lq);
  load_tile<T, D>(sDO, DO, p.do_sl, q0, p.lq);
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

    scores<T, D>(sQ + warp * 16 * S::LD_T, sK, sm.s, lane);
    scores<T, D>(sDO + warp * 16 * S::LD_T, sV, sm.dp, lane);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const float lse = sm.lse[warp * 16 + rr], delta = sm.delta[warp * 16 + rr];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float ds = 0.f;
        if (k0 + c < p.lk) {
          const float pr = expf(sm.s[rr * LD_S + c] * p.scale - lse);
          ds = pr * (sm.dp[rr * LD_S + c] - delta) * p.scale;
        }
        sm.ds[rr * S::LD_P + c] = from_f32<T>(ds);
      }
    }
    __syncwarp();
    dq.add_product(sm.ds, sK, lane);
    __syncwarp();
  }

  dq.store(sm.s, S::LD_O, lane);
  __syncwarp();
  write_rows<T, D>(DQ, p.g_sl, sm.s, q0 + warp * 16, p.lq, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_fma_kernel(const Params p) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_bwd_dkv_wgmma_kernel");
  using S = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Views<T, D> sm(smem, warp);
  T *sK = sm.tile[0], *sV = sm.tile[1], *sQ = sm.tile[2], *sDO = sm.tile[3];

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int k0 = blockIdx.x * TILE;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* DK = static_cast<T*>(p.g0) + b * p.g_sb + h * p.g_sh;
  T* DV = static_cast<T*>(p.g1) + b * p.g_sb + h * p.g_sh;

  load_tile<T, D>(sK, K, p.k_sl, k0, p.lk);
  load_tile<T, D>(sV, V, p.v_sl, k0, p.lk);

  WarpAcc<T, D> dk, dv;
  dk.zero();
  dv.zero();
  const int kv_row0 = k0 + warp * 16;
  const int n_tiles = (p.lq + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * TILE;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<T, D>(sQ, Q, p.q_sl, q0, p.lq);
    load_tile<T, D>(sDO, DO, p.do_sl, q0, p.lq);
    load_rows(sm.lse, sm.delta, p, bh, q0);
    __syncthreads();

    // transposed: row rr is kv row kv_row0 + rr, column c is q row q0 + c
    scores<T, D>(sK + warp * 16 * S::LD_T, sQ, sm.s, lane);
    scores<T, D>(sV + warp * 16 * S::LD_T, sDO, sm.dp, lane);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const bool kv_ok = kv_row0 + rr < p.lk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float pr = 0.f, ds = 0.f;
        if (kv_ok && q0 + c < p.lq) {
          pr = expf(sm.s[rr * LD_S + c] * p.scale - sm.lse[c]);
          ds = pr * (sm.dp[rr * LD_S + c] - sm.delta[c]) * p.scale;
        }
        sm.p[rr * S::LD_P + c] = from_f32<T>(pr);
        sm.ds[rr * S::LD_P + c] = from_f32<T>(ds);
      }
    }
    __syncwarp();
    dv.add_product(sm.p, sDO, lane);
    dk.add_product(sm.ds, sQ, lane);
    __syncwarp();
  }

  dk.store(sm.s, S::LD_O, lane);
  __syncwarp();
  write_rows<T, D>(DK, p.g_sl, sm.s, kv_row0, p.lk, lane);
  __syncwarp();
  dv.store(sm.s, S::LD_O, lane);
  __syncwarp();
  write_rows<T, D>(DV, p.g_sl, sm.s, kv_row0, p.lk, lane);
}

// --- bf16 / f16: wgmma fed by a TMA ring -------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;  // ring depth
constexpr int BQ = 64;     // q rows per tile of the dk/dv loop
constexpr int BK = 64;     // kv rows per tile of the dq loop

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
// tile pairs, then the mbarriers. 64-row kv tiles keep s, dp and dq (plus
// ds's A fragments) within the registers a thread has at every D.
template <int D, int NC>
struct DqCfg {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * NC + 32;
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;
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
};

// A warpgroup's 64 x D f32 accumulator, rounded to T, into rows
// row0 .. row0 + 63 of a chunked, swizzled tile of `rows` rows.
template <typename T, int D>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[D / 2], unsigned char* tile,
                                            int rows, int row0, int warp, int g, int tq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t off =
          hopper::swizzled_offset<D>(rows, row0 + 16 * warp + g + 8 * j, 8 * n + 2 * tq);
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

  const int bh = blockIdx.y;
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
  const BwdArgs args{p.lse, p.delta, p.heads, p.lq, p.lk, p.scale, p.scale * LOG2E};
  const dim3 grid((p.lk + C::BKV - 1) / C::BKV, batch * p.heads);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mdo, mdk, mdv, args);
  return static_cast<int>(cudaGetLastError());
}

// Two consumers (128-row kv tiles) when those tiles give every SM a block;
// else one. D = 128 always takes one: its four accumulators need more than
// the 224 registers a thread may hold in a block of two consumers.
template <typename T, int D>
int launch_dkv_wgmma(const Params& p, int batch, int dtype, cudaStream_t stream) {
  if constexpr (D <= 64) {
    const int64_t tiles128 = static_cast<int64_t>((p.lk + 127) / 128) * batch * p.heads;
    if (tiles128 >= sm_count()) return launch_dkv_wgmma_nc<T, D, 2>(p, batch, dtype, stream);
  }
  return launch_dkv_wgmma_nc<T, D, 1>(p, batch, dtype, stream);
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
  constexpr int BM = C::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sQ = sm;
  unsigned char* sDO = sm + C::OFF_DO;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y;
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
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D, T>(dq, da[kk], desc_mnmajor<D>(sK, BK, kk));
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
  if (r == 0) r = encode_bhld<D>(&mk, p.k, dtype, batch, p.lk, p.heads, p.k_sb, p.k_sl, p.k_sh, BK);
  if (r == 0) r = encode_bhld<D>(&mv, p.v, dtype, batch, p.lk, p.heads, p.v_sb, p.v_sl, p.v_sh, BK);
  if (r == 0) r = encode_bhld<D>(&mdq, p.g0, dtype, batch, p.lq, p.heads, p.g_sb, p.g_sl, p.g_sh, 64);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = flash_bwd_dq_wgmma_kernel<T, D, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs args{p.lse, p.delta, p.heads, p.lq, p.lk, p.scale, p.scale * LOG2E};
  const dim3 grid((p.lq + C::BM - 1) / C::BM, batch * p.heads);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mdo, mdq, args);
  return static_cast<int>(cudaGetLastError());
}

// Two consumers (128-row q tiles) when those tiles give every SM a block;
// else one, whose blocks are half the size and twice as many.
template <typename T, int D>
int launch_dq_wgmma(const Params& p, int batch, int dtype, cudaStream_t stream) {
  const int64_t tiles128 = static_cast<int64_t>((p.lq + 127) / 128) * batch * p.heads;
  if (tiles128 >= sm_count()) return launch_dq_wgmma_nc<T, D, 2>(p, batch, dtype, stream);
  return launch_dq_wgmma_nc<T, D, 1>(p, batch, dtype, stream);
}

template <typename T, int D>
int launch_fma(void (*kernel)(const Params), const Params& p, int rows, int batch,
               cudaStream_t stream) {
  using S = Smem<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + TILE - 1) / TILE, batch * p.heads);
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
                 g_sb, g_sl, g_sh, heads, lq,   lk,    scale};
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
                 g_sb, g_sl, g_sh, heads, lq,   lk,    scale};
  return dispatch(p, batch, d, dtype, false, stream);
}
