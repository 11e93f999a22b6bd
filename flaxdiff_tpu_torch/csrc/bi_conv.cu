// Batch-invariant 2-D convolution over NHWC input, as an implicit GEMM:
// for each sample z, out_z [OH*OW, Cout] = im2col(x_z) [OH*OW, K] W^T + b,
// K = KH*KW*Cin ordered (kh, kw, cin), W [Cout, KH, KW, Cin] (a torch
// [Cout, Cin, KH, KW] weight in channels-last memory). Zero padding (SAME's
// asymmetric low/high split included: the caller gives the top and left
// pads and the output size), any stride, any kernel (1x1, 3x3, a patch
// embedding's p x p at stride p); no dilation, no groups.
//
// The rows of a block tile are one sample's output pixels (blockIdx.z is the
// sample): no tile crosses a sample, and every output is one f32 sum over k
// in a fixed order (bi_mma.cuh), so a sample's bits do not depend on the
// batch's size, the sample's position or its neighbours.
//
// Replaces no TPU kernel. The JAX package's conv is XLA's conv_general_dilated
// (flax nn.Conv, flaxdiff_tpu/models/common.py); the port's ConvLayer ran
// F.conv2d, i.e. cuDNN, whose algorithms make a sample's bits follow its
// batch (fault C6, ROADMAP.md). ConvLayer takes this kernel under inference
// mode (models/common.py, ops/batch_invariant.py). Bound: operations.
#include "bi_mma.cuh"

struct ConvShape {
  int h, w, c, oh, ow, kh, kw, sh, sw, pt, pl;
};

template <typename T, bool VEC>
struct PixelsA {
  const T* x;  // this sample's [H, W, Cin]
  ConvShape s;
  int M, K, m0;
  // VEC: the first input pixel of this thread's two rows, and whether the row exists
  int ih0[2], iw0[2];
  bool live[2];

  __device__ __forceinline__ PixelsA(const T* x_, const ConvShape& s_, int m0_)
      : x(x_), s(s_), M(s_.oh * s_.ow), K(s_.kh * s_.kw * s_.c), m0(m0_) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + static_cast<int>(threadIdx.x) / 4 + 64 * i;
      const int oh = m / s.ow, ow = m - oh * s.ow;
      ih0[i] = oh * s.sh - s.pt;
      iw0[i] = ow * s.sw - s.pl;
      live[i] = m < M;
    }
  }

  __device__ __forceinline__ void fill(T* As, int k0) const {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
      // 8 consecutive channels of one (kh, kw) tap: Cin % 8 == 0
      const int kc = (tid % 4) * 8, k = k0 + kc;
      const int c = k % s.c, rs = k / s.c, r = rs / s.kw, q = rs - r * s.kw;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ih = ih0[i] + r, iw = iw0[i] + q;
        const bool valid = live[i] && k < K && ih >= 0 && ih < s.h && iw >= 0 && iw < s.w;
        const T* src = valid ? x + (static_cast<int64_t>(ih) * s.w + iw) * s.c + c : x;
        bi::cp_async16(As + (tid / 4 + 64 * i) * bi::LDS + kc, src, valid);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < bi::BM * bi::BK / bi::THREADS; ++j) {
        const int e = tid + bi::THREADS * j, row = e / bi::BK, kk = e % bi::BK;
        const int m = m0 + row, k = k0 + kk;
        As[row * bi::LDS + kk] = (m < M && k < K) ? at(m, k) : bi::zero<T>();
      }
    }
  }

  // x at output pixel m's tap k, 0 in the padding
  __device__ __forceinline__ T at(int m, int k) const {
    const int oh = m / s.ow, ow = m - oh * s.ow;
    const int c = k % s.c, rs = k / s.c, r = rs / s.kw, q = rs - r * s.kw;
    const int ih = oh * s.sh - s.pt + r, iw = ow * s.sw - s.pl + q;
    if (ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) return bi::zero<T>();
    return x[(static_cast<int64_t>(ih) * s.w + iw) * s.c + c];
  }

  __device__ __forceinline__ float get(int m, int k) const { return to_f32(at(m, k)); }
};

template <typename T, bool A_VEC, bool W_VEC>
__global__ void __launch_bounds__(bi::THREADS)
bi_conv_mma_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                   T* __restrict__ out, ConvShape s, int n) {
  const int z = blockIdx.z, m0 = blockIdx.x * bi::BM, n0 = blockIdx.y * bi::BN;
  const int M = s.oh * s.ow, K = s.kh * s.kw * s.c;
  const PixelsA<T, A_VEC> a(x + static_cast<int64_t>(z) * s.h * s.w * s.c, s, m0);
  bi::mma_tile<T, W_VEC>(a, w, bias, out + static_cast<int64_t>(z) * M * n, M, n, K, m0, n0);
}

__global__ void __launch_bounds__(bi::THREADS)
bi_conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, ConvShape s, int n) {
  const int z = blockIdx.z, m0 = blockIdx.x * bi::FM, n0 = blockIdx.y * bi::FN;
  const int M = s.oh * s.ow, K = s.kh * s.kw * s.c;
  const PixelsA<float, false> a(x + static_cast<int64_t>(z) * s.h * s.w * s.c, s, m0);
  bi::fma_tile(a, w, bias, out + static_cast<int64_t>(z) * M * n, M, n, K, m0, n0);
}

template <typename T>
static int launch(const void* x, const void* w, const void* bias, void* out, int batch,
                  const ConvShape& s, int n, cudaStream_t stream) {
  const dim3 grid((s.oh * s.ow + bi::BM - 1) / bi::BM, (n + bi::BN - 1) / bi::BN, batch);
  const bool a_vec = s.c % 8 == 0 && aligned16(x);
  const bool w_vec = (s.kh * s.kw * s.c) % 8 == 0 && aligned16(w);
  const T *xt = static_cast<const T*>(x), *wt = static_cast<const T*>(w),
          *bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  if (a_vec && w_vec)
    bi_conv_mma_kernel<T, true, true><<<grid, bi::THREADS, 0, stream>>>(xt, wt, bt, ot, s, n);
  else if (w_vec)
    bi_conv_mma_kernel<T, false, true><<<grid, bi::THREADS, 0, stream>>>(xt, wt, bt, ot, s, n);
  else if (a_vec)
    bi_conv_mma_kernel<T, true, false><<<grid, bi::THREADS, 0, stream>>>(xt, wt, bt, ot, s, n);
  else
    bi_conv_mma_kernel<T, false, false><<<grid, bi::THREADS, 0, stream>>>(xt, wt, bt, ot, s, n);
  return static_cast<int>(cudaGetLastError());
}

// x [batch, h, w, cin], w [cout, kh, kw, cin], bias [cout] or null, out
// [batch, oh, ow, cout]; all of one dtype, contiguous. pt / pl: the top and
// left zero padding; the bottom and right follow from oh, ow.
extern "C" int bi_conv(const void* x, const void* w, const void* bias, void* out, int batch,
                       int h, int w_in, int cin, int oh, int ow, int cout, int kh, int kw, int sh,
                       int sw, int pt, int pl, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || oh <= 0 || ow <= 0 || cout <= 0 || cin <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape s{h, w_in, cin, oh, ow, kh, kw, sh, sw, pt, pl};
  switch (dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, bias, out, batch, s, cout, st);
    case kFloat16:
      return launch<__half>(x, w, bias, out, batch, s, cout, st);
    case kFloat32: {
      const dim3 grid((oh * ow + bi::FM - 1) / bi::FM, (cout + bi::FN - 1) / bi::FN, batch);
      bi_conv_fma_kernel<<<grid, bi::THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(bias), static_cast<float*>(out), s, cout);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
