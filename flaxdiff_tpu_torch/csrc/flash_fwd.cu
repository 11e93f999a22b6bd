// Flash-attention forward: out = softmax(scale * q k^T, masked to kv_len) v,
// plus an optional per-row logsumexp, without materializing the score matrix.
//
// Replaces the TPU kernel `_fwd_kernel` (flaxdiff_tpu/ops/flash_attention.py:78,
// launched at :298 through `_fwd_impl` :273).
//
// Bound on the H100: operations for self-attention (4 * L^2 * D flops per
// head against 8 * L * D bytes: at L = 4096 the tensor cores are the limit),
// bytes for the 77-token cross-attention. Two kernels, chosen by dtype:
//
// flash_fwd_wgmma_kernel (bf16, f16) is built for those bounds:
//   * a block per (q tile, batch*head): one producer warp and NC consumer
//     warpgroups of 64 q rows each. The producer issues TMA: the q tile once,
//     then K and V tiles of BN rows into a 2-stage ring, each stage guarded by
//     a full and an empty mbarrier, so loads overlap the math. Operands are
//     4-D tensor maps over (D, H, L, B) with the caller's strides, so a
//     [B, L, H*D] projection needs no copy and rows past lq / kv_len load as
//     zeros. BN = 128 for D <= 64 and 64 for D = 128 and 256 (the registers
//     of the score, probability and output tiles then fit with no spill: at
//     D = 256 the output alone is 128 registers a thread);
//   * NC = 2 (128-row q tiles) when those tiles alone give every SM a block;
//     else NC = 1, whose smaller blocks (two per SM) fill the card at the
//     DiT's 256 tokens and at 1024 tokens with batch 2. D = 256 always runs
//     NC = 1, one block an SM (160 KB of tiles; launch_wgmma says why);
//   * s = q k^T is one wgmma chain (A = q, B = k, both K-major in shared
//     memory under the 128-byte swizzle, 64-byte for D = 32). The online
//     softmax runs on the accumulator registers: a thread holds two rows, the
//     row max and sum take two quad shuffles, scale * log2(e) is folded into
//     exp2f, and columns at or past kv_len score -1e30 (flash_attention.py:
//     39,104) on the last kv tile only;
//   * p is rounded to the input dtype in registers, against the running max
//     as the TPU kernel does, and is the register-A operand of p v (the
//     accumulator layout of s is the A-fragment layout for 16-bit types); v
//     is the MN-major B operand through the transpose bit (two wgmma of
//     N = 128 at D = 256, one on each column half). The output is rescaled
//     and l accumulated in registers: scores and probabilities never touch
//     shared memory;
//   * the epilogue divides by l, writes the warpgroup's rows into its own
//     (consumed) q tile in the swizzled layout and stores them with TMA,
//     which skips rows at or past lq; lse = (m2 + log2 l) ln 2, natural-log
//     units, as [B*H, Lq] f32.
//
// flash_fwd_fma_kernel (f32) keeps f32 results f32-exact (the tensor cores
// would round them to TF32): 64-row kv tiles, 4 warps of 16 q rows (8 at
// D = 256, where three padded 64-row tiles and the warps' accumulators
// would not fit), FMA loops, scores through a per-warp shared scratch.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
constexpr int BN = TILE;  // kv rows per tile of the f32 kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B*H, Lq] or nullptr
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t o_sb, o_sl, o_sh;
  int heads, lq, lk;
  float scale;
  int bhs;  // batch * heads
};

// --- f32: FMA loops ------------------------------------------------------------

// Shared-memory layout (leading dimensions from flash_common.cuh): the q
// tile of BM = 4 RW rows, the K and V tiles of BN rows, probabilities, the
// per-warp scratch, the row statistics.
template <typename T, int D>
struct Smem {
  static constexpr int RW = warp_rows<D>();
  static constexpr int BM = NWARPS * RW;        // q rows per block
  static constexpr int LD_T = ld_tile<T, D>();  // q, k, v tiles
  static constexpr int LD_P = ld_p<T>();        // probabilities in T
  static constexpr int LD_O = D + 4;            // f32 p v product
  // per-warp scratch: scores of its RW rows, later reused for their p v
  static constexpr int WARP_SCRATCH = (RW * LD_S > RW * LD_O ? RW * LD_S : RW * LD_O);
  static constexpr int TILE_BYTES = align128(BN * LD_T * static_cast<int>(sizeof(T)));
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + align128(BM * LD_T * static_cast<int>(sizeof(T)));
  static constexpr int OFF_V = OFF_K + TILE_BYTES;
  static constexpr int OFF_P = OFF_V + TILE_BYTES;
  static constexpr int OFF_W = OFF_P + align128(BM * LD_P * static_cast<int>(sizeof(T)));
  static constexpr int OFF_STATS = OFF_W + align128(NWARPS * WARP_SCRATCH * 4);
  static constexpr int BYTES = OFF_STATS + 3 * BM * 4;  // running max, sum, rescale
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_fma_kernel(const Params p) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_fwd_wgmma_kernel");
  using S = Smem<T, D>;
  constexpr int RW = S::RW, BM = S::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::OFF_Q);
  T* sK = reinterpret_cast<T*>(smem + S::OFF_K);
  T* sV = reinterpret_cast<T*>(smem + S::OFF_V);
  T* sP = reinterpret_cast<T*>(smem + S::OFF_P);
  float* sM = reinterpret_cast<float*>(smem + S::OFF_STATS);
  float* sL = sM + BM;
  float* sA = sL + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sW = reinterpret_cast<float*>(smem + S::OFF_W) + warp * S::WARP_SCRATCH;

  const int bh = split_bh();
  if (bh >= p.bhs) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * BM;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // q rows past lq load as zeros, so their (discarded) softmax stays finite
  load_tile<T, D, BM>(sQ, Q, p.q_sl, q0, p.lq);
  if (threadIdx.x < BM) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }

  // lane owns elements e = lane + 32 * i of its warp's RW x D output rows
  constexpr int OPL = RW * D / 32;
  float acc[OPL];
#pragma unroll
  for (int i = 0; i < OPL; ++i) acc[i] = 0.f;

  const int n_tiles = (p.lk + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(sK, K, p.k_sl, k0, p.lk);
    load_tile<T, D>(sV, V, p.v_sl, k0, p.lk);
    __syncthreads();

    scores<T, D>(sQ + warp * RW * S::LD_T, sK, sW, lane);
    __syncwarp();

    // online softmax over this warp's RW rows; each lane holds 2 of 64 columns
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      const float* srow = sW + rr * LD_S;
      float s0 = srow[lane] * p.scale;
      float s1 = srow[lane + 32] * p.scale;
      if (k0 + lane >= p.lk) s0 = NEG_INF;
      if (k0 + lane + 32 >= p.lk) s1 = NEG_INF;
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_next);
      const float p1 = expf(s1 - m_next);
      const float row_sum = warp_sum(p0 + p1);
      T* prow = sP + r * S::LD_P;
      prow[lane] = from_f32<T>(p0);
      prow[lane + 32] = from_f32<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + row_sum;
        sM[r] = m_next;
      }
    }
    __syncwarp();

    // the scores are consumed: the warp's scratch now takes its p v rows
    {
      WarpAcc<T, D> pv;
      pv.zero();
      pv.add_product(sP + warp * RW * S::LD_P, sV, lane);
      pv.store(sW, S::LD_O, lane);
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < OPL; ++i) {
      const int e = lane + 32 * i;
      const int rr = e / D, col = e - rr * D;
      acc[i] = acc[i] * sA[warp * RW + rr] + sW[rr * S::LD_O + col];
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < OPL; ++i) {
    const int e = lane + 32 * i;
    const int rr = e / D, col = e - rr * D;
    const int r = warp * RW + rr;
    const int row = q0 + r;
    if (row < p.lq) {
      const float inv_l = 1.0f / fmaxf(sL[r], 1e-30f);
      O[row * p.o_sl + col] = from_f32<T>(acc[i] * inv_l);
    }
  }
  if (p.lse != nullptr && lane < RW) {
    const int r = warp * RW + lane;
    const int row = q0 + r;
    if (row < p.lq)
      p.lse[static_cast<int64_t>(bh) * p.lq + row] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

// --- bf16 / f16: wgmma fed by a TMA ring ------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int STAGES = 2;  // K/V ring depth

// Tile sizes and the shared-memory layout of the wgmma kernel: the q tile,
// then STAGES (K, V) tile pairs, then the mbarriers. Every tile is a whole
// number of 1024-byte swizzle atoms.
template <int D, int NC>
struct FwdCfg {
  static constexpr int BM = 64 * NC;           // q rows per block
  static constexpr int BN = D <= 64 ? 128 : 64;  // kv rows per tile
  static constexpr int THREADS = 128 * NC + 32;  // consumers, then the producer warp
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int OFF_KV = Q_BYTES;
  static constexpr int OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles of whole swizzle atoms");
};

struct FwdArgs {
  float* lse;  // [B*H, Lq] or nullptr
  int heads, lq, lk;
  float scale_log2;  // scale * log2(e)
  int bhs;           // batch * heads
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D, int NC>
__global__ void __launch_bounds__(FwdCfg<D, NC>::THREADS, NC == 1 && D <= 128 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mo, const FwdArgs a) {
  using C = FwdCfg<D, NC>;
  using namespace hopper;
  constexpr int BM = C::BM, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sQ = sm;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int bh = split_bh();
  if (bh >= a.bhs) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = (a.lk + BN - 1) / BN;
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

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // the producer warp: one lane issues every load
    if (threadIdx.x % 32 == 0) {
      mbar_arrive_expect_tx(bar_q, C::Q_BYTES);
      tma_load_tile<D>(sQ, &mq, bar_q, BM, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES, use = t / STAGES;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        unsigned char* sK = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
        mbar_arrive_expect_tx(&full[st], 2 * C::KV_BYTES);
        tma_load_tile<D>(sK, &mk, &full[st], BN, h, t * BN, b);
        tma_load_tile<D>(sK + C::KV_BYTES, &mv, &full[st], BN, h, t * BN, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64 wg .. + 63 of the block
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const unsigned char* sK = sm + C::OFF_KV + st * 2 * C::KV_BYTES;
    const unsigned char* sV = sK + C::KV_BYTES;
    mbar_wait(&full[st], (t / STAGES) & 1);

    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN, T>(s, desc_kmajor<D>(sQ, BM, 64 * wg, kk), desc_kmajor<D>(sK, BN, 0, kk),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scores in log2 units; columns at or past kv_len on the last tile only
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] *= a.scale_log2;
    if ((t + 1) * BN > a.lk) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = t * BN + 8 * (i / 4) + 2 * tq + (i % 2);
        if (col >= a.lk) s[i] = NEG_INF;
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = m[j];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * j], s[4 * n + 2 * j + 1]));
      mx = quad_max(mx);
      alpha[j] = exp2f(m[j] - mx);
      m[j] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        s[4 * n + 2 * j] = exp2f(s[4 * n + 2 * j] - mx);
        s[4 * n + 2 * j + 1] = exp2f(s[4 * n + 2 * j + 1] - mx);
        sum += s[4 * n + 2 * j] + s[4 * n + 2 * j + 1];
      }
      l[j] = l[j] * alpha[j] + sum;  // this thread's columns; the quad's sum at the end
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(s, kk, pa[kk]);

    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_cols<D, T>(o, pa[kk], sV, BN, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: O / l into this warpgroup's rows of the consumed q tile, then TMA
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = fmaxf(quad_sum(l[j]), 1e-30f);
    inv[j] = 1.0f / l[j];
  }
  const int row_in_tile = 64 * wg + 16 * warp + g;
  if (a.lse != nullptr && tq == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + row_in_tile + 8 * j;
      if (row < a.lq) a.lse[static_cast<int64_t>(bh) * a.lq + row] = (m[j] + log2f(l[j])) * LN2;
    }
  }
  named_barrier(1 + wg, 128);  // every warp of the group is done reading its q rows
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t off = swizzled_offset<D>(BM, row_in_tile + 8 * j, 8 * n + 2 * tq);
      *reinterpret_cast<uint32_t*>(sQ + off) =
          pack2<T>(o[4 * n + 2 * j] * inv[j], o[4 * n + 2 * j + 1] * inv[j]);
    }
  fence_async_smem();
  named_barrier(1 + wg, 128);
  if (tid == 0) {
    tma_store_tile<D>(&mo, sQ + 64 * wg * chunk_row_bytes<D>(), BM, h, q0 + 64 * wg, b);
    tma_store_wait();
  }
}

template <typename T, int D, int NC>
int launch_wgmma_nc(const Params& p, int batch, int dtype, cudaStream_t stream) {
  using C = FwdCfg<D, NC>;
  using hopper::encode_bhld;
  CUtensorMap mq, mk, mv, mo;
  int r = encode_bhld<D>(&mq, p.q, dtype, batch, p.lq, p.heads, p.q_sb, p.q_sl, p.q_sh, C::BM);
  if (r == 0) r = encode_bhld<D>(&mk, p.k, dtype, batch, p.lk, p.heads, p.k_sb, p.k_sl, p.k_sh, C::BN);
  if (r == 0) r = encode_bhld<D>(&mv, p.v, dtype, batch, p.lk, p.heads, p.v_sb, p.v_sl, p.v_sh, C::BN);
  if (r == 0) r = encode_bhld<D>(&mo, p.o, dtype, batch, p.lq, p.heads, p.o_sb, p.o_sl, p.o_sh, 64);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = flash_fwd_wgmma_kernel<T, D, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdArgs args{p.lse, p.heads, p.lq, p.lk, p.scale * LOG2E, p.bhs};
  dim3 grid;
  if (!split_bh_grid((p.lq + C::BM - 1) / C::BM, p.bhs, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mo, args);
  return static_cast<int>(cudaGetLastError());
}

// Two consumers (128-row q tiles) when those tiles give every SM a block;
// else one, whose blocks are half the size and twice as many. D = 256 always
// takes one: a block of two consumers and the producer warp is nine warps,
// three of them on one of the SM's four register files, which caps a thread
// at 168 registers; the output alone is 128 there.
template <typename T, int D>
int launch_wgmma(const Params& p, int batch, int dtype, cudaStream_t stream) {
  if constexpr (D <= 128) {
    const int64_t tiles128 = static_cast<int64_t>((p.lq + 127) / 128) * batch * p.heads;
    if (tiles128 >= sm_count()) return launch_wgmma_nc<T, D, 2>(p, batch, dtype, stream);
  }
  return launch_wgmma_nc<T, D, 1>(p, batch, dtype, stream);
}

template <int D>
int launch_fma(const Params& p, int batch, cudaStream_t stream) {
  using S = Smem<float, D>;
  auto kernel = flash_fwd_fma_kernel<float, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  if (!split_bh_grid((p.lq + S::BM - 1) / S::BM, p.bhs, 1, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, NTHREADS, S::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 takes the FMA kernel, bf16 and f16 the wgmma kernel: a dispatch on the
// dtype, with no fallback from one to the other.
template <int D>
int dispatch_dtype(const Params& p, int batch, int dtype, cudaStream_t s) {
  switch (dtype) {
    case kFloat32: return launch_fma<D>(p, batch, s);
    case kBFloat16: return launch_wgmma<__nv_bfloat16, D>(p, batch, dtype, s);
    case kFloat16: return launch_wgmma<__half, D>(p, batch, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- head dims above 256: the column-chunked (wide) kernels -------------------
//
// Also replace `_fwd_kernel` (flash_attention.py:78), which the reference
// runs at any head dim padded to a multiple of 128. A 64-row f32 output of
// D > 256 columns does not fit one warpgroup's registers, so the grid gets a
// third dimension over column chunks of the output (WIDE_COLS_16 = 128
// columns for bf16/f16, WIDE_COLS_F32 = 64 for f32; a last chunk of 64 where
// D % 128 == 64). Every block recomputes the whole score tile over the full
// head dim, summed WIDE_CHUNK = 64 columns at a time through shared memory:
// nothing in shared memory has the head dim as a dimension, so every D fits.
// It keeps only its own columns of the output. The blocks of one q tile do
// the same arithmetic in the same order, so their row max, row sum and lse
// are bit-equal: chunk 0 writes lse (with lse_chunk_stride != 0 every chunk
// writes its own copy, for the test that holds them equal). Each block does
// the whole score work, (D / W) x the forward's flops in all: a kernel that
// is right before it is fast.
//
// flash_fwd_wide_wgmma_kernel (bf16, f16): one warpgroup of 64 q rows. The
// score chunks (q and k, 64 columns each) stream through a 2-stage ring by
// TMA, thread 0 issuing chunk u + 2 once every warp has read chunk u; the
// V tile of the block's columns arrives on its own barrier while the next
// tile's scores run. s = q k^T is D / 16 wgmma in chunks of four (D = 64's
// K-major layout), the online softmax is the D <= 256 kernel's, and o += p v
// is four wgmma of N = 128 with p from registers (D = 128's MN-major layout).
//
// flash_fwd_wide_fma_kernel (f32): the f32 kernel at D = 64 (4 warps of 16
// q rows, FMA loops), its q and k tiles loaded 64 columns at a time with the
// scores summed across them, and v's tile the block's 64 columns.

struct WideArgs {
  float* lse;  // [B*H, Lq] (x chunks with lse_chunk_stride) or nullptr
  int64_t lse_chunk_stride;
  int heads, lq, lk, d;
  float scale_log2;
  int bhs;   // batch * heads
  int bits;  // z's low bits holding the column chunk: chunk_bits(chunks)
};

struct WideFwdCfg {
  static constexpr int BM = 64, BN = 64, W = WIDE_COLS_16, CH = WIDE_CHUNK;
  static constexpr int THREADS = 128;
  static constexpr int CHUNK_BYTES = 64 * CH * 2;      // a 64-row, 64-column tile
  static constexpr int STAGE_BYTES = 2 * CHUNK_BYTES;  // q and k
  static constexpr int OFF_V = STAGES * STAGE_BYTES;
  static constexpr int OFF_BAR = OFF_V + BN * W * 2;
  static constexpr int BYTES = OFF_BAR + 8 * (STAGES + 1) + 1024;  // + base alignment
};

template <typename T>
__global__ void __launch_bounds__(WideFwdCfg::THREADS)
    flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const __grid_constant__ CUtensorMap mo, const WideArgs a) {
  using C = WideFwdCfg;
  using namespace hopper;
  constexpr int BM = C::BM, BN = C::BN, W = C::W, CH = C::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* sV = sm + C::OFF_V;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* bar_v = full + STAGES;

  const int chunks = (a.d + W - 1) / W, chunk = split_chunk(a.bits);
  const int bh = split_bh(a.bits);
  if (bh >= a.bhs || chunk >= chunks) return;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * BM, col0 = chunk * W;
  const int nd = a.d / CH;
  const int n_tiles = (a.lk + BN - 1) / BN;
  const int total = n_tiles * nd;
  // the block's output columns as 64-column boxes: one where they pass D
  const int vboxes = col0 + CH < a.d ? 2 : 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init(bar_v, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // score chunk u: kv tile u / nd, head-dim columns 64 (u % nd) ..
  auto issue = [&](int u) {
    const int st = u % STAGES, t = u / nd, c = (u - t * nd) * CH;
    unsigned char* s = sm + st * C::STAGE_BYTES;
    mbar_arrive_expect_tx(&full[st], C::STAGE_BYTES);
    tma_load_4d(s, &mq, &full[st], c, h, q0, b);
    tma_load_4d(s + C::CHUNK_BYTES, &mk, &full[st], c, h, t * BN, b);
  };
  // kv tile t of V, the block's columns (a skipped box leaves columns that
  // only feed output columns past D, which are never stored)
  auto issue_v = [&](int t) {
    mbar_arrive_expect_tx(bar_v, vboxes * BN * CH * 2);
    for (int j = 0; j < vboxes; ++j)
      tma_load_4d(sV + j * BN * CH * 2, &mv, bar_v, col0 + j * CH, h, t * BN, b);
  };
  if (tid == 0) {
    for (int u = 0; u < STAGES && u < total; ++u) issue(u);
    issue_v(0);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units

  for (int t = 0; t < n_tiles; ++t) {
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    for (int c = 0; c < nd; ++c) {
      const int u = t * nd + c, st = u % STAGES;
      const unsigned char* sQ = sm + st * C::STAGE_BYTES;
      const unsigned char* sK = sQ + C::CHUNK_BYTES;
      mbar_wait(&full[st], (u / STAGES) & 1);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma_ss<BN, T>(s, desc_kmajor<CH>(sQ, BM, 0, kk), desc_kmajor<CH>(sK, BN, 0, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      __syncthreads();  // every warp is done reading stage st
      if (tid == 0 && u + STAGES < total) issue(u + STAGES);
    }

    // the D <= 256 kernel's online softmax, in log2 units
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] *= a.scale_log2;
    if ((t + 1) * BN > a.lk) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = t * BN + 8 * (i / 4) + 2 * tq + (i % 2);
        if (col >= a.lk) s[i] = NEG_INF;
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = m[j];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * j], s[4 * n + 2 * j + 1]));
      mx = quad_max(mx);
      alpha[j] = exp2f(m[j] - mx);
      m[j] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        s[4 * n + 2 * j] = exp2f(s[4 * n + 2 * j] - mx);
        s[4 * n + 2 * j + 1] = exp2f(s[4 * n + 2 * j + 1] - mx);
        sum += s[4 * n + 2 * j] + s[4 * n + 2 * j + 1];
      }
      l[j] = l[j] * alpha[j] + sum;
    }
#pragma unroll
    for (int n = 0; n < W / 8; ++n) {
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(s, kk, pa[kk]);

    mbar_wait(bar_v, t & 1);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<W, T>(o, pa[kk], desc_mnmajor<W>(sV, BN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // every warp is done reading V
    if (tid == 0 && t + 1 < n_tiles) issue_v(t + 1);
  }

  // epilogue: O / l into the (consumed) V tile, then TMA stores of the
  // block's boxes, which skip rows at or past lq
  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = fmaxf(quad_sum(l[j]), 1e-30f);
    inv[j] = 1.0f / l[j];
  }
  const int row_in_tile = 16 * warp + g;
  if (a.lse != nullptr && tq == 0 && (chunk == 0 || a.lse_chunk_stride != 0)) {
    float* lse = a.lse + chunk * a.lse_chunk_stride + static_cast<int64_t>(bh) * a.lq;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + row_in_tile + 8 * j;
      if (row < a.lq) lse[row] = (m[j] + log2f(l[j])) * LN2;
    }
  }
#pragma unroll
  for (int n = 0; n < W / 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t off = swizzled_offset<W>(BM, row_in_tile + 8 * j, 8 * n + 2 * tq);
      *reinterpret_cast<uint32_t*>(sV + off) =
          pack2<T>(o[4 * n + 2 * j] * inv[j], o[4 * n + 2 * j + 1] * inv[j]);
    }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < vboxes; ++j)
      tma_store_4d(&mo, sV + j * BM * CH * 2, col0 + j * CH, h, q0, b);
    tma_store_wait();
  }
}

template <typename T>
int launch_wide_wgmma(const Params& p, const WideArgs& args, int batch, int dtype,
                      cudaStream_t stream) {
  using C = WideFwdCfg;
  using hopper::encode_bhld_wide;
  CUtensorMap mq, mk, mv, mo;
  const int d = args.d;
  int r = encode_bhld_wide(&mq, p.q, dtype, batch, p.lq, p.heads, d, p.q_sb, p.q_sl, p.q_sh, C::BM);
  if (r == 0) r = encode_bhld_wide(&mk, p.k, dtype, batch, p.lk, p.heads, d, p.k_sb, p.k_sl, p.k_sh, C::BN);
  if (r == 0) r = encode_bhld_wide(&mv, p.v, dtype, batch, p.lk, p.heads, d, p.v_sb, p.v_sl, p.v_sh, C::BN);
  if (r == 0) r = encode_bhld_wide(&mo, p.o, dtype, batch, p.lq, p.heads, d, p.o_sb, p.o_sl, p.o_sh, C::BM);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = flash_fwd_wide_wgmma_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (d + C::W - 1) / C::W;
  dim3 grid;
  if (!split_bh_grid((p.lq + C::BM - 1) / C::BM, p.bhs, chunks, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  WideArgs a = args;
  a.bits = chunk_bits(chunks);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mq, mk, mv, mo, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_wide_fma_kernel(const Params p,
                                                                      const WideArgs a) {
  static_assert(kIsF32<T>, "the 16-bit types take flash_fwd_wide_wgmma_kernel");
  constexpr int D = WIDE_CHUNK;  // the tiles' columns: a score chunk, or the block's output
  using S = Smem<T, D>;
  constexpr int RW = S::RW, BM = S::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::OFF_Q);
  T* sK = reinterpret_cast<T*>(smem + S::OFF_K);
  T* sV = reinterpret_cast<T*>(smem + S::OFF_V);
  T* sP = reinterpret_cast<T*>(smem + S::OFF_P);
  float* sM = reinterpret_cast<float*>(smem + S::OFF_STATS);
  float* sL = sM + BM;
  float* sA = sL + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sW = reinterpret_cast<float*>(smem + S::OFF_W) + warp * S::WARP_SCRATCH;

  const int chunks = a.d / WIDE_COLS_F32, chunk = split_chunk(a.bits);
  const int bh = split_bh(a.bits);
  if (bh >= p.bhs || chunk >= chunks) return;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * BM, col0 = chunk * WIDE_COLS_F32;
  const int nd = a.d / D;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + col0;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + col0;

  if (threadIdx.x < BM) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }
  constexpr int OPL = RW * D / 32;
  float acc[OPL];
#pragma unroll
  for (int i = 0; i < OPL; ++i) acc[i] = 0.f;

  const int n_tiles = (p.lk + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    for (int c = 0; c < nd; ++c) {
      __syncthreads();  // every warp is done with the previous tiles
      // q rows past lq load as zeros, so their (discarded) softmax stays finite
      load_tile<T, D, BM>(sQ, Q + c * D, p.q_sl, q0, p.lq);
      load_tile<T, D>(sK, K + c * D, p.k_sl, k0, p.lk);
      if (c == 0) load_tile<T, D>(sV, V, p.v_sl, k0, p.lk);
      __syncthreads();
      scores<T, D>(sQ + warp * RW * S::LD_T, sK, sW, lane, c > 0);
    }
    __syncwarp();

    // the D <= 256 kernel's online softmax over this warp's RW rows
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      const float* srow = sW + rr * LD_S;
      float s0 = srow[lane] * p.scale;
      float s1 = srow[lane + 32] * p.scale;
      if (k0 + lane >= p.lk) s0 = NEG_INF;
      if (k0 + lane + 32 >= p.lk) s1 = NEG_INF;
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_next);
      const float p1 = expf(s1 - m_next);
      const float row_sum = warp_sum(p0 + p1);
      T* prow = sP + r * S::LD_P;
      prow[lane] = from_f32<T>(p0);
      prow[lane + 32] = from_f32<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + row_sum;
        sM[r] = m_next;
      }
    }
    __syncwarp();
    {
      WarpAcc<T, D> pv;
      pv.zero();
      pv.add_product(sP + warp * RW * S::LD_P, sV, lane);
      pv.store(sW, S::LD_O, lane);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < OPL; ++i) {
      const int e = lane + 32 * i;
      const int rr = e / D, col = e - rr * D;
      acc[i] = acc[i] * sA[warp * RW + rr] + sW[rr * S::LD_O + col];
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < OPL; ++i) {
    const int e = lane + 32 * i;
    const int rr = e / D, col = e - rr * D;
    const int r = warp * RW + rr;
    const int row = q0 + r;
    if (row < p.lq) {
      const float inv_l = 1.0f / fmaxf(sL[r], 1e-30f);
      O[row * p.o_sl + col] = from_f32<T>(acc[i] * inv_l);
    }
  }
  if (a.lse != nullptr && lane < RW && (chunk == 0 || a.lse_chunk_stride != 0)) {
    const int r = warp * RW + lane;
    const int row = q0 + r;
    if (row < p.lq)
      a.lse[chunk * a.lse_chunk_stride + static_cast<int64_t>(bh) * p.lq + row] =
          sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

int launch_wide_fma(const Params& p, const WideArgs& args, int batch, cudaStream_t stream) {
  using S = Smem<float, WIDE_CHUNK>;
  auto kernel = flash_fwd_wide_fma_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = args.d / WIDE_COLS_F32;
  dim3 grid;
  if (!split_bh_grid((p.lq + S::BM - 1) / S::BM, p.bhs, chunks, &grid))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  WideArgs a = args;
  a.bits = chunk_bits(chunks);
  kernel<<<grid, NTHREADS, S::BYTES, stream>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
                         int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb,
                         int64_t o_sl, int64_t o_sh, int batch, int heads, int lq, int lk, int d,
                         float scale, int dtype, void* stream) {
  if (lq <= 0 || lk <= 0 || batch <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    lse,  q_sb,  q_sl, q_sh, k_sb, k_sl,  k_sh,
                 v_sb, v_sl, v_sh, o_sb, o_sl, o_sh, heads, lq,   lk,   scale, batch * heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return dispatch_dtype<32>(p, batch, dtype, s);
    case 64: return dispatch_dtype<64>(p, batch, dtype, s);
    case 128: return dispatch_dtype<128>(p, batch, dtype, s);
    case 256: return dispatch_dtype<256>(p, batch, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Head dims above 256, a multiple of 64 (the wide kernels). lse_chunk_stride
// 0 has column chunk 0 write lse; otherwise chunk c writes its own copy at
// lse + c * lse_chunk_stride.
extern "C" int flash_fwd_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                              int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
                              int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
                              int64_t v_sh, int64_t o_sb, int64_t o_sl, int64_t o_sh, int batch,
                              int heads, int lq, int lk, int d, float scale, int dtype,
                              int64_t lse_chunk_stride, void* stream) {
  if (lq <= 0 || lk <= 0 || batch <= 0 || heads <= 0 || d < WIDE_MIN_D || d % WIDE_CHUNK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    lse,  q_sb,  q_sl, q_sh, k_sb, k_sl,  k_sh,
                 v_sb, v_sl, v_sh, o_sb, o_sl, o_sh, heads, lq,   lk,   scale, batch * heads};
  const WideArgs args{lse, lse_chunk_stride, heads, lq, lk, d, scale * LOG2E, batch * heads, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_wide_fma(p, args, batch, s);
    case kBFloat16: return launch_wide_wgmma<__nv_bfloat16>(p, args, batch, dtype, s);
    case kFloat16: return launch_wide_wgmma<__half>(p, args, batch, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
