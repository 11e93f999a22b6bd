// Shared pieces of the flash-attention kernels that stage tiles through
// shared memory (flash_fwd.cu's and flash_bwd.cu's f32 kernels, and the dq
// kernel for every dtype): 64-row tiles, 4 warps of 16 rows each, and the
// products one warp computes on its 16 rows.
//
// bf16/f16 products (the dq kernel's) run on the tensor cores through WMMA
// (f32 accumulation). f32 inputs take plain FMA loops, so f32 results stay
// f32-exact (the tensor cores would round them to TF32). WMMA hides which
// lane holds which element, so scores and probabilities go through shared
// memory, where every lane can read whole rows. The 16-bit forward and dk/dv
// kernels do not use these pieces: they run on wgmma (hopper.cuh).
#pragma once

#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace flash {

constexpr int TILE = 64;      // rows of a q or kv tile
constexpr int NWARPS = 4;     // 16 rows of a tile per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int LD_S = TILE + 4;  // leading dimension of f32 16 x TILE scores

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Leading dimension of a [TILE, D] tile of T in shared memory: padded by one
// 16-byte vector, so rows stay 16-byte aligned (and WMMA fragment starts
// 32-byte aligned) while consecutive rows fall on different banks.
template <typename T, int D>
__host__ __device__ constexpr int ld_tile() { return D + vec16<T>(); }

// Leading dimension of a 16 x TILE block of probabilities in T.
template <typename T>
__host__ __device__ constexpr int ld_p() { return TILE + vec16<T>(); }

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// TILE rows of D elements, row r from src row row0 + r (row stride
// stride_l), with 16-byte loads; rows at or past rows_total load as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride_l, int row0,
                                          int rows_total) {
  constexpr int V = vec16<T>();
  constexpr int VPR = D / V;
  constexpr int LD = ld_tile<T, D>();
  for (int i = threadIdx.x; i < TILE * VPR; i += NTHREADS) {
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

// s[16 x TILE] = a[16 x D] . b[TILE x D]^T for one warp: a is the warp's 16
// rows of a tile, b a whole tile (both row-major, leading dimension
// ld_tile), s f32 with leading dimension LD_S.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* a, const T* b, float* s, int lane) {
  constexpr int LD = ld_tile<T, D>();
  if constexpr (kIsF32<T>) {
    for (int rr = 0; rr < 16; ++rr) {
      const float* arow = a + rr * LD;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* brow = b + (lane + 32 * half) * LD;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc = fmaf(arow[d], brow[d], acc);
        s[rr * LD_S + lane + 32 * half] = acc;
      }
    }
  } else {
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILE / 16];
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
      wmma::load_matrix_sync(af, a + kk, LD);
#pragma unroll
      for (int j = 0; j < TILE / 16; ++j) {
        // B(k, n) = b[n][k]: the row-major tile read as a column-major B
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, b + j * 16 * LD + kk, LD);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j)
      wmma::store_matrix_sync(s + j * 16, acc[j], LD_S, wmma::mem_row_major);
  }
}

// A warp's 16 x D f32 accumulator of products p[16 x TILE] . b[TILE x D],
// p in T (leading dimension ld_p), b a row-major tile. In WMMA fragments for
// bf16/f16; for f32, lane owns elements e = lane + 32 i of the block.
template <typename T, int D, bool F32 = kIsF32<T>>
struct WarpAcc;

template <typename T, int D>
struct WarpAcc<T, D, false> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) nvcuda::wmma::fill_fragment(f[j], 0.f);
  }

  __device__ __forceinline__ void add_product(const T* p, const T* b, int /*lane*/) {
    using namespace nvcuda;
    constexpr int LD = ld_tile<T, D>();
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af;
      wmma::load_matrix_sync(af, p + kk, ld_p<T>());
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, b + kk * LD + j * 16, LD);
        wmma::mma_sync(f[j], af, bf, f[j]);
      }
    }
  }

  // the block, f32 row-major with leading dimension ldo, into shared memory
  __device__ __forceinline__ void store(float* out, int ldo, int /*lane*/) const {
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      nvcuda::wmma::store_matrix_sync(out + j * 16, f[j], ldo, nvcuda::wmma::mem_row_major);
  }
};

template <typename T, int D>
struct WarpAcc<T, D, true> {
  static constexpr int PER_LANE = 16 * D / 32;
  float v[PER_LANE];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) v[i] = 0.f;
  }

  // each tile's product is summed in full, then added, as the tensor-core
  // path and the TPU kernels do
  __device__ __forceinline__ void add_product(const float* p, const float* b, int lane) {
    constexpr int LD = ld_tile<float, D>();
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      const int rr = e / D, col = e - rr * D;
      const float* prow = p + rr * ld_p<float>();
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < TILE; ++j) s = fmaf(prow[j], b[j * LD + col], s);
      v[i] += s;
    }
  }

  __device__ __forceinline__ void store(float* out, int ldo, int lane) const {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      const int rr = e / D, col = e - rr * D;
      out[rr * ldo + col] = v[i];
    }
  }
};

}  // namespace flash
