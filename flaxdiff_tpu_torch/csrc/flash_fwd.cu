// Flash-attention forward: out = softmax(scale * q k^T, masked to kv_len) v,
// plus an optional per-row logsumexp, without materializing the score matrix.
//
// Replaces the TPU kernel `_fwd_kernel` (flaxdiff_tpu/ops/flash_attention.py:78,
// launched at :298 through `_fwd_impl` :273).
//
// Bound on the H100: operations for self-attention (4 * L^2 * D flops per
// head against 8 * L * D bytes: at L = 4096 the tensor cores are the limit),
// bytes for the 77-token cross-attention. The design:
//   * one block of 4 warps per (64-row q tile, batch*head); each warp owns 16
//     q rows, so softmax state and the output accumulator never leave the warp;
//   * K/V tiles of 64 rows are staged through shared memory with 16-byte loads
//     and shared by the 4 warps;
//   * q k^T and p v run on the tensor cores through WMMA (bf16/f16 inputs,
//     f32 accumulation); f32 inputs take a plain FMA path so that f32 results
//     stay f32-exact (the tensor cores would round them to TF32);
//   * the online softmax is f32; columns at or past kv_len score -1e30, as at
//     flash_attention.py:39,104, which covers the 77-token context and ragged
//     tiles. p is rounded to the input dtype before p v, as the TPU kernel does;
//   * operands are addressed through explicit (batch, seq, head) strides, so a
//     [B, L, H*D] projection reaches the kernel as a view with no transpose;
//   * lse is stored as [B*H, Lq] f32 (the TPU's 128-lane replication is gone).
// wgmma/TMA pipelining is later work; this version is right and simple first.
#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int NWARPS = 4;     // 16 q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

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
};

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout. Leading dimensions are padded by one 16-byte vector so
// rows stay 16-byte aligned (and WMMA fragment starts 32-byte aligned) while
// consecutive rows fall on different banks.
template <typename T, int D>
struct Smem {
  static constexpr int LD_T = D + vec16<T>();   // q, k, v tiles
  static constexpr int LD_S = BN + 4;           // f32 scores
  static constexpr int LD_P = BN + vec16<T>();  // probabilities in T
  static constexpr int LD_O = D + 4;            // f32 p v product
  // per-warp scratch: scores of its 16 rows, later reused for their p v
  static constexpr int WARP_SCRATCH = (16 * LD_S > 16 * LD_O ? 16 * LD_S : 16 * LD_O);
  static constexpr int TILE = align128(BM * LD_T * static_cast<int>(sizeof(T)));
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + TILE;
  static constexpr int OFF_V = OFF_K + TILE;
  static constexpr int OFF_P = OFF_V + TILE;
  static constexpr int OFF_W = OFF_P + align128(BM * LD_P * static_cast<int>(sizeof(T)));
  static constexpr int OFF_STATS = OFF_W + align128(NWARPS * WARP_SCRATCH * 4);
  static constexpr int BYTES = OFF_STATS + 3 * BM * 4;  // running max, sum, rescale
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride_l, int row0,
                                          int rows_total) {
  constexpr int V = vec16<T>();
  constexpr int VPR = D / V;
  constexpr int LD = Smem<T, D>::LD_T;
  for (int i = threadIdx.x; i < BM * VPR; i += NTHREADS) {
    const int r = i / VPR, cv = i - r * VPR;
    const int row = row0 + r;
    Vec<T, V> val;
    if (row < rows_total) {
      val = load_vec<T, V>(src + row * stride_l + cv * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) val.v[e] = from_f32<T>(0.f);
    }
    store_vec<T, V>(dst + r * LD + cv * V, val);
  }
}

// scores[16 x BN] of this warp's rows = q_rows . k_tile^T on the tensor cores.
template <typename T, int D>
__device__ __forceinline__ void scores_mma(const T* sQ, const T* sK, float* sS, int warp) {
  using namespace nvcuda;
  constexpr int LD = Smem<T, D>::LD_T;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + warp * 16 * LD + kk, LD);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      // B(k, n) = K[n][k]: the row-major K tile read as a column-major B
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, sK + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(sS + j * 16, acc[j], Smem<T, D>::LD_S, wmma::mem_row_major);
}

// pv[16 x D] of this warp's rows = p_rows . v_tile on the tensor cores.
template <typename T, int D>
__device__ __forceinline__ void pv_mma(const T* sP, const T* sV, float* sO, int warp) {
  using namespace nvcuda;
  constexpr int LD = Smem<T, D>::LD_T;
  constexpr int LDP = Smem<T, D>::LD_P;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < BN; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::load_matrix_sync(a, sP + warp * 16 * LDP + kk, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, sV + kk * LD + j * 16, LD);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(sO + j * 16, acc[j], Smem<T, D>::LD_O, wmma::mem_row_major);
}

// f32 inputs: the same two products with plain FMAs, in full f32.
template <int D>
__device__ __forceinline__ void scores_fma(const float* sQ, const float* sK, float* sS, int warp,
                                           int lane) {
  constexpr int LD = Smem<float, D>::LD_T;
  for (int rr = 0; rr < 16; ++rr) {
    const float* qrow = sQ + (warp * 16 + rr) * LD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* krow = sK + (lane + 32 * half) * LD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      sS[rr * Smem<float, D>::LD_S + lane + 32 * half] = s;
    }
  }
}

template <int D>
__device__ __forceinline__ void pv_fma(const float* sP, const float* sV, float* sO, int warp,
                                       int lane) {
  constexpr int LD = Smem<float, D>::LD_T;
  constexpr int LDP = Smem<float, D>::LD_P;
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, col = e - rr * D;
    const float* prow = sP + (warp * 16 + rr) * LDP;
    float s = 0.f;
#pragma unroll 16
    for (int j = 0; j < BN; ++j) s = fmaf(prow[j], sV[j * LD + col], s);
    sO[rr * Smem<float, D>::LD_O + col] = s;
  }
}

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
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  using S = Smem<T, D>;
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

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * BM;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // q rows past lq load as zeros, so their (discarded) softmax stays finite
  load_tile<T, D>(sQ, Q, p.q_sl, q0, p.lq);
  if (threadIdx.x < BM) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }

  // lane owns elements e = lane + 32 * i of its warp's 16 x D output rows
  constexpr int OPL = 16 * D / 32;
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

    if constexpr (std::is_same<T, float>::value) {
      scores_fma<D>(sQ, sK, sW, warp, lane);
    } else {
      scores_mma<T, D>(sQ, sK, sW, warp);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; each lane holds 2 of 64 columns
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const float* srow = sW + rr * S::LD_S;
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
    if constexpr (std::is_same<T, float>::value) {
      pv_fma<D>(sP, sV, sW, warp, lane);
    } else {
      pv_mma<T, D>(sP, sV, sW, warp);
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < OPL; ++i) {
      const int e = lane + 32 * i;
      const int rr = e / D, col = e - rr * D;
      acc[i] = acc[i] * sA[warp * 16 + rr] + sW[rr * S::LD_O + col];
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < OPL; ++i) {
    const int e = lane + 32 * i;
    const int rr = e / D, col = e - rr * D;
    const int r = warp * 16 + rr;
    const int row = q0 + r;
    if (row < p.lq) {
      const float inv_l = 1.0f / fmaxf(sL[r], 1e-30f);
      O[row * p.o_sl + col] = from_f32<T>(acc[i] * inv_l);
    }
  }
  if (p.lse != nullptr && lane < 16) {
    const int r = warp * 16 + lane;
    const int row = q0 + r;
    if (row < p.lq)
      p.lse[static_cast<int64_t>(bh) * p.lq + row] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using S = Smem<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.lq + BM - 1) / BM, batch * p.heads);
  kernel<<<grid, NTHREADS, S::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl,
                         int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb,
                         int64_t o_sl, int64_t o_sh, int batch, int heads, int lq, int lk, int d,
                         float scale, int dtype, void* stream) {
  if (lq <= 0 || lk <= 0 || batch <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    o,    lse,  q_sb,  q_sl, q_sh, k_sb, k_sl,  k_sh,
                 v_sb, v_sl, v_sh, o_sb, o_sl, o_sh, heads, lq,   lk,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return dispatch_d<float>(p, batch, d, s);
    case kBFloat16: return dispatch_d<__nv_bfloat16>(p, batch, d, s);
    case kFloat16: return dispatch_d<__half>(p, batch, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
