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
// five products of the backward plus the two the split recomputes. The
// design:
//   * the JAX split, with no atomics, so the gradients are deterministic: a dq
//     block per (64-row q tile, batch*head) looping over the kv tiles, and a
//     dk/dv block per (64-row kv tile, batch*head) looping over the q tiles;
//   * 4 warps of 16 rows, tiles staged through shared memory with 16-byte
//     loads, products on the tensor cores through WMMA for bf16/f16 and in
//     FMAs for f32, as in the forward (flash_common.cuh);
//   * the dk/dv kernel computes its scores transposed, k q^T and v dO^T, so a
//     warp's 16 kv rows of p^T and ds^T are the row-major A operands of
//     p^T dO and ds^T q: no transpose anywhere;
//   * scores and dP go through a per-warp f32 scratch (WMMA hides the row
//     mapping), p and ds through a per-warp buffer in the input dtype; the
//     16 x D gradient accumulators stay in registers across the loop;
//   * q rows at or past lq and kv rows at or past kv_len (the 77-token text
//     context, ragged tiles) load as zeros and are masked out of p and ds,
//     so they add exactly 0, and no gradient row past the end is written;
//   * operands and gradients are addressed through explicit (batch, seq,
//     head) strides, so the [B, L, H*D] projections need no transpose.
// wgmma/TMA pipelining is later work; this version is right and simple first.
#include "flash_common.cuh"

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
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Params p) {
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
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Params p) {
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

template <typename T, int D>
int launch(const Params& p, int batch, bool dq, cudaStream_t stream) {
  using S = Smem<T, D>;
  void (*kernel)(const Params) = flash_bwd_dkv_kernel<T, D>;
  if (dq) kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = dq ? p.lq : p.lk;
  const dim3 grid((rows + TILE - 1) / TILE, batch * p.heads);
  kernel<<<grid, NTHREADS, S::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int batch, int d, bool dq, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, dq, stream);
    case 64: return launch<T, 64>(p, batch, dq, stream);
    case 128: return launch<T, 128>(p, batch, dq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Params& p, int batch, int d, int dtype, bool dq, void* stream) {
  if (p.lq <= 0 || p.lk <= 0 || batch <= 0 || p.heads <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_d<float>(p, batch, d, dq, s);
    case kBFloat16: return dispatch_d<__nv_bfloat16>(p, batch, d, dq, s);
    case kFloat16: return dispatch_d<__half>(p, batch, d, dq, s);
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
