// Shared pieces of the f32 flash-attention kernels (flash_fwd.cu's and
// flash_bwd.cu's FMA kernels), which stage tiles through shared memory:
// 64-row tiles streamed past the block's own tile of 4 warps x RW rows, and
// the products one warp computes on its RW rows in plain FMA loops, so f32
// results stay f32-exact (the tensor cores would round them to TF32). RW is
// 16, and 8 at D = 256, where a warp's f32 accumulators (RW * D / 32 a lane)
// and four padded tiles would not fit the registers and shared memory.
// Scores and probabilities go through shared memory, where every lane can
// read whole rows. The 16-bit kernels run on wgmma (hopper.cuh) and share
// only the constants and the grid helpers below.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace flash {

constexpr int TILE = 64;      // rows of a streamed q or kv tile
constexpr int NWARPS = 4;     // RW rows of the block's own tile per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int LD_S = TILE + 4;  // leading dimension of f32 RW x TILE scores

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Head dims above 256 (any multiple of 64) take the wide kernels: the grid
// has a third dimension over column chunks of the output, WIDE_COLS_16
// columns a block for bf16/f16 (a 64 x 128 f32 accumulator, 64 registers a
// thread) and WIDE_COLS_F32 for f32 (the FMA kernels' D = 64 tiles), and
// every block sums its score tiles over the head dim WIDE_CHUNK columns at
// a time (flaxdiff_tpu_torch/ops/flash_attention.py mirrors these).
constexpr int WIDE_CHUNK = 64;
constexpr int WIDE_COLS_16 = 128;
constexpr int WIDE_COLS_F32 = 64;
constexpr int WIDE_MIN_D = 320;

// Every flash grid keeps a block's tile on x and splits batch*heads over y
// and z: bh = y + gridDim.y * z, with y at most 65535, so batch*heads may
// pass y's limit of 65535 (a video UNet's temporal attention runs B*H*W
// sequences of frames); blocks past the count return at once. Every index
// is a special register and constants, which the compiler re-reads where it
// needs it instead of holding a derived value across the kernel's loops (a
// quotient held there made ptxas spill in the f32 dq kernels), and with one
// z the blocks run in the order they did before. The wide kernels keep
// their column chunk in the low `bits` bits of z, chunk_bits(chunks) of
// them, a kernel argument; past 65535 batch*heads, the chunk slots a block
// of z leaves empty return at once.
__host__ __device__ constexpr int chunk_bits(int chunks) {
  return chunks <= 1 ? 0 : 1 + chunk_bits((chunks + 1) / 2);
}

__device__ __forceinline__ int split_bh(int bits = 0) {
  return static_cast<int>(blockIdx.y + gridDim.y * (blockIdx.z >> bits));
}

__device__ __forceinline__ int split_chunk(int bits) {
  return static_cast<int>(blockIdx.z & ((1u << bits) - 1u));
}

// The grid of `tiles` tiles for each of `bh` batch*heads; the wide kernels'
// `chunks` column chunks in the chunk_bits(chunks) low bits of z. False
// where a dimension would pass its limit.
inline bool split_bh_grid(int64_t tiles, int64_t bh, int chunks, dim3* grid) {
  if (bh < 1 || chunks < 1) return false;
  const int64_t hi = (bh + 65534) / 65535, y = (bh + hi - 1) / hi;
  const int64_t z = ((hi - 1) << chunk_bits(chunks)) + chunks;
  if (tiles < 1 || tiles > 0x7fffffff || y < 1 || z > 65535) return false;
  *grid = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(y),
               static_cast<unsigned>(z));
  return true;
}

// Rows a warp owns of the block's own tile (q rows, or kv rows for dk/dv).
template <int D>
__host__ __device__ constexpr int warp_rows() { return D == 256 ? 8 : 16; }

// Leading dimension of a [TILE, D] tile of T in shared memory: padded by one
// 16-byte vector, so rows stay 16-byte aligned while consecutive rows fall
// on different banks.
template <typename T, int D>
__host__ __device__ constexpr int ld_tile() { return D + vec16<T>(); }

// Leading dimension of an RW x TILE block of probabilities in T.
template <typename T>
__host__ __device__ constexpr int ld_p() { return TILE + vec16<T>(); }

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// ROWS rows of D elements, row r from src row row0 + r (row stride
// stride_l), with 16-byte loads; rows at or past rows_total load as zeros.
template <typename T, int D, int ROWS = TILE>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t stride_l, int row0,
                                          int rows_total) {
  constexpr int V = vec16<T>();
  constexpr int VPR = D / V;
  constexpr int LD = ld_tile<T, D>();
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
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

// s[RW x TILE] = a[RW x D] . b[TILE x D]^T for one warp: a is the warp's RW
// rows of a tile, b a whole tile (both row-major, leading dimension
// ld_tile), s with leading dimension LD_S. With `accumulate`, s += instead:
// the wide kernels sum the scores over the head dim 64 columns at a time.
template <typename T, int D>
__device__ __forceinline__ void scores(const T* a, const T* b, float* s, int lane,
                                       bool accumulate = false) {
  static_assert(kIsF32<T>, "the 16-bit types run on wgmma");
  constexpr int LD = ld_tile<T, D>();
  for (int rr = 0; rr < warp_rows<D>(); ++rr) {
    const float* arow = a + rr * LD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* brow = b + (lane + 32 * half) * LD;
      float acc = accumulate ? s[rr * LD_S + lane + 32 * half] : 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(arow[d], brow[d], acc);
      s[rr * LD_S + lane + 32 * half] = acc;
    }
  }
}

// A warp's RW x D f32 accumulator of products p[RW x TILE] . b[TILE x D], p
// with leading dimension ld_p, b a row-major tile; lane owns elements
// e = lane + 32 i of the block.
template <typename T, int D>
struct WarpAcc {
  static_assert(kIsF32<T>, "the 16-bit types run on wgmma");
  static constexpr int PER_LANE = warp_rows<D>() * D / 32;
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

  // the block to rows row0 .. of a global [rows, D] view (row stride
  // stride_l), those below rows_total: a warp's 32 lanes write 32
  // neighbouring columns of one row
  __device__ __forceinline__ void write_rows(T* out, int64_t stride_l, int row0, int rows_total,
                                             int lane) const {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      const int rr = e / D, col = e - rr * D;
      if (row0 + rr < rows_total) out[(row0 + rr) * stride_l + col] = from_f32<T>(v[i]);
    }
  }
};

}  // namespace flash
