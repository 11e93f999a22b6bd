// Shared pieces of the f32 flash-attention kernels (flash_fwd.cu's and
// flash_bwd.cu's FMA kernels), which stage tiles through shared memory:
// 64-row tiles, 4 warps of 16 rows each, and the products one warp computes
// on its 16 rows in plain FMA loops, so f32 results stay f32-exact (the
// tensor cores would round them to TF32). Scores and probabilities go
// through shared memory, where every lane can read whole rows. The 16-bit
// kernels do not use these pieces: they run on wgmma (hopper.cuh).
#pragma once

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
// 16-byte vector, so rows stay 16-byte aligned while consecutive rows fall
// on different banks.
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
// ld_tile), s with leading dimension LD_S.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* a, const T* b, float* s, int lane) {
  static_assert(kIsF32<T>, "the 16-bit types run on wgmma");
  constexpr int LD = ld_tile<T, D>();
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
}

// A warp's 16 x D f32 accumulator of products p[16 x TILE] . b[TILE x D], p
// with leading dimension ld_p, b a row-major tile; lane owns elements
// e = lane + 32 i of the block.
template <typename T, int D>
struct WarpAcc {
  static_assert(kIsF32<T>, "the 16-bit types run on wgmma");
  static constexpr int PER_LANE = 16 * D / 32;
  float v[PER_LANE];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) v[i] = 0.f;
  }

  // each tile's product is summed in full, then added, as the TPU kernels do
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

  // the block, row-major with leading dimension ldo, into shared memory
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
