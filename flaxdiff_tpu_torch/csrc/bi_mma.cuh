// The main loop shared by the batch-invariant GEMM (bi_gemm.cu) and the
// implicit-GEMM convolution (bi_conv.cu):
//
//   out[z][m][n] = sum_k A_z(m, k) * W[n][k] + bias[n]
//
// where A_z is either rows of a matrix (the linear) or one sample's im2col
// view (the convolution, z = the sample), W is [N][K] with K contiguous.
//
// Batch invariance is the point of these kernels. Every output element is
// one f32 accumulator that runs over k in one fixed order: K tiles of BK in
// ascending order, and inside a tile the same sequence of mma.sync k16 steps
// (16-bit types) or of FMAs (f32). The tile shape is a constant of the
// kernel, never chosen from the row count; there is no split-K and no
// stream-K, and the epilogue adds the bias to the finished sum. So a row's
// bits depend on its own data, K and the dtype alone: not on how many rows
// the call has, where the row sits, or what the other rows hold. Zero
// padding past K, M or N adds exact zeros to no accumulator that is written.
//
// These are the routes the Hopper loop (bi_wgmma.cuh) does not take: the
// 16-bit path for shapes TMA cannot tile (K or N not a multiple of 8, a
// convolution with a stride, or input channels not a multiple of 64) runs on
// the tensor cores through mma.sync m16n8k16 (a 128 x 128 block tile, eight
// warps of 64 x 32, operands staged through a two-stage cp.async ring in
// padded shared memory and read with ldmatrix); f32 runs by FMA on a 64 x 64
// tile, 4 x 4 outputs a thread.
#pragma once

#include "common.cuh"

namespace bi {

// the 16-bit kernel: block tile, threads, smem row stride (BK + 8 elements =
// 80 bytes: the eight rows an ldmatrix reads fall in eight different 16-byte
// bank groups)
constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256, LDS = BK + 8;
// the f32 kernel
constexpr int FM = 64, FN = 64, FK = 16, FLD = FM + 4;

template <typename T>
__device__ __forceinline__ T zero() { return from_f32<T>(0.0f); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// W's tile [BN rows][BK] into shared memory: 16-byte chunks by cp.async when
// K is a multiple of 8 and W is 16-byte aligned (VEC), else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void load_w_tile(T* Bs, const T* __restrict__ w, int n0, int k0, int N,
                                            int K) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = tid / 4 + 64 * i, kc = (tid % 4) * 8;
      const int n = n0 + row, k = k0 + kc;
      const bool valid = n < N && k < K;
      cp_async16(Bs + row * LDS + kc, valid ? w + static_cast<int64_t>(n) * K + k : w, valid);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < BN * BK / THREADS; ++j) {
      const int e = tid + THREADS * j, row = e / BK, kk = e % BK;
      const int n = n0 + row, k = k0 + kk;
      Bs[row * LDS + kk] = (n < N && k < K) ? w[static_cast<int64_t>(n) * K + k] : zero<T>();
    }
  }
}

// One block's BM x BN tile of out (rows m0.., columns n0..; `out` already at
// this z, `ld` = N): the two-stage ring, ldmatrix, mma.sync, then the bias.
// ALoad::fill(As, k0) stages A's BM x BK tile at k0 (cp.async or stores).
template <typename T, bool W_VEC, class ALoad>
__device__ __forceinline__ void mma_tile(const ALoad& a, const T* __restrict__ w,
                                         const T* __restrict__ bias, T* __restrict__ out, int M,
                                         int N, int K, int m0, int n0) {
  __shared__ __align__(16) T As[2][BM * LDS];
  __shared__ __align__(16) T Bs[2][BN * LDS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;  // 2 x 4 warps of 64 x 32
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int tiles = (K + BK - 1) / BK;
  a.fill(As[0], 0);
  load_w_tile<T, W_VEC>(Bs[0], w, n0, 0, N, K);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < tiles) {
      a.fill(As[cur ^ 1], (kt + 1) * BK);
      load_w_tile<T, W_VEC>(Bs[cur ^ 1], w, n0, (kt + 1) * BK, N, K);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed (tile kt + 1 may be in flight)
    __syncthreads();
    const T* as = As[cur];
    const T* bs = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + (wm * 64 + i * 16 + lane % 16) * LDS + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        ldmatrix_x4(r, bs + (wn * 32 + j * 16 + lane % 8 + (lane / 16) * 8) * LDS + kk +
                           ((lane / 8) % 2) * 8);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<T>::run(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // the next iteration refills this stage
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + lane / 4 + 8 * h;
        if (row >= M) continue;
        T* dst = out + static_cast<int64_t>(row) * N;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (col + c < N) {
            const float b = bias ? to_f32(bias[col + c]) : 0.0f;
            dst[col + c] = from_f32<T>(acc[i][j][2 * h + c] + b);
          }
        }
      }
    }
  }
}

// The f32 tile: FM x FN outputs, 4 x 4 a thread, k in order one FMA at a
// time. ALoad::get(m, k) reads A (0 past its edges).
template <class ALoad>
__device__ __forceinline__ void fma_tile(const ALoad& a, const float* __restrict__ w,
                                         const float* __restrict__ bias, float* __restrict__ out,
                                         int M, int N, int K, int m0, int n0) {
  __shared__ __align__(16) float As[FK][FLD];
  __shared__ __align__(16) float Bs[FK][FLD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int j = 0; j < FM * FK / THREADS; ++j) {
      const int e = tid + THREADS * j, row = e / FK, kk = e % FK;
      const int k = k0 + kk;
      As[kk][row] = (m0 + row < M && k < K) ? a.get(m0 + row, k) : 0.0f;
      const int n = n0 + row;
      Bs[kk][row] = (n < N && k < K) ? w[static_cast<int64_t>(n) * K + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[static_cast<int64_t>(row) * N + col] = acc[i][j] + (bias ? bias[col] : 0.0f);
    }
  }
}

}  // namespace bi
