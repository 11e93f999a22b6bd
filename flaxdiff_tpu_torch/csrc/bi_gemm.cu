// Batch-invariant linear: y[m] = x[m] W^T + b over the rows of x [M, K],
// W [N, K], b [N] (or none), in bf16, f16 (tensor cores, f32 sums) or f32
// (FMA). A row's bits do not depend on M or on the row's position: each
// output is one f32 sum over k in a fixed order, on a route the caller picks
// from N, K and the dtype alone (ops/batch_invariant.py: gemm_route).
//
// Replaces no TPU kernel. The JAX package's Dense is XLA's dot_general
// (flax nn.Dense, flaxdiff_tpu/models/common.py), and the port's Dense ran
// F.linear, i.e. cuBLAS, whose choice of algorithm (tiles, split-K) follows
// the row count: a served request's bits then followed its batch (fault C6,
// ROADMAP.md). The port's Dense takes this kernel under inference mode
// (models/common.py, ops/batch_invariant.py).
//
// Routes:
//   * bi_gemm_wgmma_kernel<T, 128> (bf16, f16 with K and N multiples of
//     8, the 16-byte strides TMA needs): bi_wgmma.cuh's loop on 128 x 128
//     tiles, x and W as 2-D tensor maps, the output stored by TMA (an N
//     below a tile's 128 columns, as the time embedding's 64 at the UNet's
//     level 0, is TMA's zero fill and a skipped store). Bound: operations at the served
//     models' large shapes, the output's bytes where K is small (the GEGLU
//     input writes 8x what it reads), which the whole-row TMA stores serve;
//   * bi_gemm_mma_kernel (any other bf16 / f16 shape, such as K 100):
//     mma.sync on a 128 x 128 tile (bi_mma.cuh);
//   * bi_gemm_fma_kernel (f32): FMA on a 64 x 64 tile (bi_mma.cuh), f32-exact
//     (the tensor cores would round to TF32).
#include "bi_mma.cuh"
#include "bi_wgmma.cuh"

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

// x, W and out as 2-D tensor maps (x [M, K] in BK x 128 boxes, W [N, K] in
// BK x BN boxes, out [M, N] in 64 x 64 boxes), each 128-byte swizzled.
template <typename T, int BN>
__global__ void __launch_bounds__(biw::Cfg<BN>::THREADS, 2)
    bi_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                         const __grid_constant__ CUtensorMap mw,
                         const __grid_constant__ CUtensorMap mo, const T* __restrict__ bias,
                         int n, int k) {
  using C = biw::Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  auto issue = [&](int u, unsigned char* sA, uint64_t* bar) {
    hopper::mbar_arrive_expect_tx(bar, C::STAGE_BYTES);
    hopper::tma_load_2d(sA, &mx, bar, u * biw::BK, m0);
    hopper::tma_load_2d(sA + C::A_BYTES, &mw, bar, u * biw::BK, n0);
  };
  float acc[BN / 2];
  biw::mainloop<T, C>(sm, (k + biw::BK - 1) / biw::BK, issue, acc);
  unsigned char* out = biw::stage_out<T, C>(sm, acc, bias, n0, n);
  const int row0 = m0 + 64 * static_cast<int>(threadIdx.x / 128);
  biw::store_chunks<C>(out, n0, n, [&](const unsigned char* chunk, int c) {
    hopper::tma_store_2d(&mo, chunk, n0 + 64 * c, row0);
  });
}

template <typename T, int BN>
static int launch_wgmma(const void* x, const void* w, const void* bias, void* out, int64_t m,
                        int n, int k, int dtype, cudaStream_t stream) {
  using C = biw::Cfg<BN>;
  const auto swz = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap mx, mw, mo;
  const uint64_t dx[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t dw[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(n)};
  const uint64_t dout[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(m)};
  const uint64_t sk = static_cast<uint64_t>(k) * 2, sn = static_cast<uint64_t>(n) * 2;
  const uint32_t bx[2] = {biw::BK, C::BM}, bw[2] = {biw::BK, BN}, bo[2] = {64, 64};
  int r = hopper::encode_tiled(&mx, x, dtype, 2, dx, &sk, bx, swz);
  if (r == 0) r = hopper::encode_tiled(&mw, w, dtype, 2, dw, &sk, bw, swz);
  if (r == 0) r = hopper::encode_tiled(&mo, out, dtype, 2, dout, &sn, bo, swz);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = bi_gemm_wgmma_kernel<T, BN>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = biw::allow_smem(kernel, C::BYTES, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((m + C::BM - 1) / C::BM), (n + BN - 1) / BN);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mx, mw, mo, static_cast<const T*>(bias), n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* x, const void* w, const void* bias, void* out, int64_t m, int n,
                  int k, int dtype, int route, cudaStream_t stream) {
  if (route == kRouteMma) {
    const dim3 grid(static_cast<unsigned>((m + bi::BM - 1) / bi::BM), (n + bi::BN - 1) / bi::BN);
    const bool vec = k % 8 == 0 && aligned16(x) && aligned16(w);
    auto args = [&](auto kernel) {
      kernel<<<grid, bi::THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                               static_cast<const T*>(bias), static_cast<T*>(out),
                                               m, n, k);
    };
    if (vec)
      args(bi_gemm_mma_kernel<T, true>);
    else
      args(bi_gemm_mma_kernel<T, false>);
    return static_cast<int>(cudaGetLastError());
  }
  // the wgmma routes: TMA needs 16-byte strides and base addresses
  if (k % 8 != 0 || n % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route != kRouteWgmma128x128) return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma<T, 128>(x, w, bias, out, m, n, k, dtype, stream);
}

// x [m, k], w [n, k], bias [n] or null, out [m, n]; all of one dtype,
// contiguous. route: gemm_route's code (bi_wgmma.cuh's BiRoute); a route
// that does not take this dtype or shape is an error, never a fallback.
extern "C" int bi_gemm(const void* x, const void* w, const void* bias, void* out, int64_t m,
                       int n, int k, int dtype, int route, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, bias, out, m, n, k, dtype, route, s);
    case kFloat16:
      return launch<__half>(x, w, bias, out, m, n, k, dtype, route, s);
    case kFloat32: {
      if (route != kRouteFma) return static_cast<int>(cudaErrorInvalidValue);
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
