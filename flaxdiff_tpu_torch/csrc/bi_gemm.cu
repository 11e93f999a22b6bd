// Batch-invariant linear: y[m] = x[m] W^T + b over the rows of x [M, K],
// W [N, K], b [N] (or none), in bf16, f16 (tensor cores, f32 sums) or f32
// (FMA). A row's bits do not depend on M or on the row's position: each
// output is one f32 sum over k in a fixed order (bi_mma.cuh).
//
// Replaces no TPU kernel. The JAX package's Dense is XLA's dot_general
// (flax nn.Dense, flaxdiff_tpu/models/common.py), and the port's Dense ran
// F.linear, i.e. cuBLAS, whose choice of algorithm (tiles, split-K) follows
// the row count: a served request's bits then followed its batch (fault C6,
// ROADMAP.md). The port's Dense takes this kernel under inference mode
// (models/common.py, ops/batch_invariant.py). Bound: operations (see
// bi_mma.cuh).
#include "bi_mma.cuh"

template <typename T, bool VEC>
struct RowsA {
  const T* x;
  int64_t M;
  int K, m0;
  __device__ __forceinline__ void fill(T* As, int k0) const {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = tid / 4 + 64 * i, kc = (tid % 4) * 8;
        const int64_t m = m0 + row;
        const int k = k0 + kc;
        const bool valid = m < M && k < K;
        bi::cp_async16(As + row * bi::LDS + kc, valid ? x + m * K + k : x, valid);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < bi::BM * bi::BK / bi::THREADS; ++j) {
        const int e = tid + bi::THREADS * j, row = e / bi::BK, kk = e % bi::BK;
        const int64_t m = m0 + row;
        const int k = k0 + kk;
        As[row * bi::LDS + kk] = (m < M && k < K) ? x[m * K + k] : bi::zero<T>();
      }
    }
  }
  __device__ __forceinline__ float get(int m, int k) const {
    return to_f32(x[static_cast<int64_t>(m) * K + k]);
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(bi::THREADS)
bi_gemm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, int64_t M, int N, int K) {
  const int m0 = blockIdx.x * bi::BM, n0 = blockIdx.y * bi::BN;
  const RowsA<T, VEC> a{x, M, K, m0};
  bi::mma_tile<T, VEC>(a, w, bias, out, static_cast<int>(M), N, K, m0, n0);
}

__global__ void __launch_bounds__(bi::THREADS)
bi_gemm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int64_t M, int N,
                   int K) {
  const int m0 = blockIdx.x * bi::FM, n0 = blockIdx.y * bi::FN;
  const RowsA<float, false> a{x, M, K, m0};
  bi::fma_tile(a, w, bias, out, static_cast<int>(M), N, K, m0, n0);
}

template <typename T>
static int launch(const void* x, const void* w, const void* bias, void* out, int64_t m, int n,
                  int k, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + bi::BM - 1) / bi::BM), (n + bi::BN - 1) / bi::BN);
  const bool vec = k % 8 == 0 && aligned16(x) && aligned16(w);
  auto args = [&](auto kernel) {
    kernel<<<grid, bi::THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                             static_cast<const T*>(bias), static_cast<T*>(out), m,
                                             n, k);
  };
  if (vec)
    args(bi_gemm_mma_kernel<T, true>);
  else
    args(bi_gemm_mma_kernel<T, false>);
  return static_cast<int>(cudaGetLastError());
}

// x [m, k], w [n, k], bias [n] or null, out [m, n]; all of one dtype, contiguous.
extern "C" int bi_gemm(const void* x, const void* w, const void* bias, void* out, int64_t m,
                       int n, int k, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, bias, out, m, n, k, s);
    case kFloat16:
      return launch<__half>(x, w, bias, out, m, n, k, s);
    case kFloat32: {
      const dim3 grid(static_cast<unsigned>((m + bi::FM - 1) / bi::FM), (n + bi::FN - 1) / bi::FN);
      bi_gemm_fma_kernel<<<grid, bi::THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(bias), static_cast<float*>(out), m, n, k);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
