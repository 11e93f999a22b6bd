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
// in a fixed order, on a route the caller picks from the per-sample
// geometry and the dtype alone (ops/batch_invariant.py: conv_route), so a
// sample's bits do not depend on the batch's size, the sample's position or
// its neighbours.
//
// Replaces no TPU kernel. The JAX package's conv is XLA's conv_general_dilated
// (flax nn.Conv, flaxdiff_tpu/models/common.py); the port's ConvLayer ran
// F.conv2d, i.e. cuDNN, whose algorithms make a sample's bits follow its
// batch (fault C6, ROADMAP.md). ConvLayer takes this kernel under inference
// mode (models/common.py, ops/batch_invariant.py).
//
// Routes:
//   * bi_conv_wgmma_kernel<T, BN> (bf16, f16; stride 1, Cin a multiple of
//     64, Cout of 8: every 3x3 and 1x1 conv of the UNet past conv_in):
//     bi_wgmma.cuh's loop. A block's 128 output pixels are a tile_h x tile_w
//     rectangle of one sample's output (tile_w the output width rounded up
//     to a power of two, at most 128), and k tile u is tap (kh, kw) = the
//     u / (Cin / 64)-th, channels 64 (u % (Cin / 64)) ..: one TMA box
//     [64 channels, tile_w, tile_h, 1] of the NHWC input at (c0, ow0 + kw -
//     pl, oh0 + kh - pt, z), whose out-of-range pixels TMA fills with zeros:
//     the padding, SAME's asymmetric split included, costs nothing. The
//     output is a 4-D tensor map too. Bound: operations (2 * 9 * Cin flops
//     per output element against ~4 bytes). BN is picked from Cout: 64 up to
//     64 outputs (the UNet's level 0), 128 otherwise. Level 3's 3x3 at 512
//     channels then gives the card 64 blocks at batch 2 (128 x 64 would give
//     128, but loses at a bucket-8 round's batch 16, PERF.md), with no
//     split-K;
//   * bi_conv_mma_kernel (any other bf16 / f16 conv: conv_in's 3 channels,
//     the stride-2 downsample, DiT's patch embedding): mma.sync on a 128 x
//     128 tile with im2col loads by cp.async (bi_mma.cuh);
//   * bi_conv_narrow_kernel<CP> (f32, Cout <= 8, stride 1: the UNet's
//     conv_out to 3 channels): one thread per output pixel of a 128-pixel
//     row segment in each of two output rows, all Cout sums in registers
//     over k in the (kh, kw, cin) order, W [K, Cout padded to CP] in shared
//     memory (read as broadcasts), each input row of the segment staged in
//     shared memory once by coalesced 16-byte loads and read for both
//     output rows. Bound: bytes (the input, read once from
//     device memory). FMA, f32-exact: TF32 would miss the f32 limits;
//   * bi_conv_fma_kernel (any other f32 conv): FMA on a 64 x 64 tile
//     (bi_mma.cuh).
#include "bi_mma.cuh"
#include "bi_wgmma.cuh"

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

// The wgmma route's geometry: the output pixel tile (tile_h x tile_w,
// tiles_w across the output's width), the taps and channel tiles.
struct TileGeom {
  int kw, pt, pl, cin_tiles, taps, tile_w, tile_h, tiles_w;
};

// x as a 4-D tensor map over (Cin, W, H, B) in [64, tile_w, tile_h, 1]
// boxes, W as a 2-D map over (K, Cout) in [64, BN] boxes, out as a 4-D map
// over (Cout, OW, OH, B) in [64, sub_w, sub_h, 1] boxes (a warpgroup's 64
// pixels), each 128-byte swizzled.
template <typename T, int BN>
__global__ void __launch_bounds__(biw::Cfg<BN>::THREADS, 2)
    bi_conv_wgmma_kernel(const __grid_constant__ CUtensorMap mx,
                         const __grid_constant__ CUtensorMap mw,
                         const __grid_constant__ CUtensorMap mo, const T* __restrict__ bias,
                         int n, TileGeom g) {
  using C = biw::Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align_smem(smem_raw);
  const int z = blockIdx.z, n0 = blockIdx.y * BN;
  const int th = blockIdx.x / g.tiles_w, tw = blockIdx.x - th * g.tiles_w;
  const int oh0 = th * g.tile_h, ow0 = tw * g.tile_w;
  auto issue = [&](int u, unsigned char* sA, uint64_t* bar) {
    const int tap = u / g.cin_tiles, c0 = (u - tap * g.cin_tiles) * biw::BK;
    const int r = tap / g.kw, q = tap - r * g.kw;
    hopper::mbar_arrive_expect_tx(bar, C::STAGE_BYTES);
    hopper::tma_load_4d(sA, &mx, bar, c0, ow0 + q - g.pl, oh0 + r - g.pt, z);
    hopper::tma_load_2d(sA + C::A_BYTES, &mw, bar, u * biw::BK, n0);
  };
  float acc[BN / 2];
  biw::mainloop<T, C>(sm, g.taps * g.cin_tiles, issue, acc);
  unsigned char* out = biw::stage_out<T, C>(sm, acc, bias, n0, n);
  // the warpgroup's first pixel of the tile
  const int p0 = 64 * static_cast<int>(threadIdx.x / 128);
  const int i0 = p0 / g.tile_w, j0 = p0 - i0 * g.tile_w;
  biw::store_chunks<C>(out, n0, n, [&](const unsigned char* chunk, int c) {
    hopper::tma_store_4d(&mo, chunk, n0 + 64 * c, ow0 + j0, oh0 + i0, z);
  });
}

template <typename T, int BN>
static int launch_wgmma(const void* x, const void* w, const void* bias, void* out, int batch,
                        const ConvShape& s, int n, int dtype, cudaStream_t stream) {
  using C = biw::Cfg<BN>;
  TileGeom g;
  g.kw = s.kw;
  g.pt = s.pt;
  g.pl = s.pl;
  g.cin_tiles = s.c / biw::BK;
  g.taps = s.kh * s.kw;
  g.tile_w = 1;
  while (g.tile_w < s.ow && g.tile_w < C::BM) g.tile_w *= 2;
  g.tile_h = C::BM / g.tile_w;
  g.tiles_w = (s.ow + g.tile_w - 1) / g.tile_w;
  const int sub_w = g.tile_w < 64 ? g.tile_w : 64, sub_h = 64 / sub_w;
  const int64_t tiles = static_cast<int64_t>(g.tiles_w) * ((s.oh + g.tile_h - 1) / g.tile_h);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto swz = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t es = 2;
  const int64_t k = static_cast<int64_t>(g.taps) * s.c;
  const uint64_t dx[4] = {static_cast<uint64_t>(s.c), static_cast<uint64_t>(s.w),
                          static_cast<uint64_t>(s.h), static_cast<uint64_t>(batch)};
  const uint64_t sx[3] = {es * s.c, es * s.c * s.w, es * s.c * s.w * s.h};
  const uint32_t bx[4] = {biw::BK, static_cast<uint32_t>(g.tile_w),
                          static_cast<uint32_t>(g.tile_h), 1};
  const uint64_t dw[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(n)};
  const uint64_t sw = es * k;
  const uint32_t bw[2] = {biw::BK, BN};
  const uint64_t dout[4] = {static_cast<uint64_t>(n), static_cast<uint64_t>(s.ow),
                            static_cast<uint64_t>(s.oh), static_cast<uint64_t>(batch)};
  const uint64_t so[3] = {es * n, es * n * s.ow, es * n * s.ow * s.oh};
  const uint32_t bo[4] = {64, static_cast<uint32_t>(sub_w), static_cast<uint32_t>(sub_h), 1};
  CUtensorMap mx, mw, mo;
  int r = hopper::encode_tiled(&mx, x, dtype, 4, dx, sx, bx, swz);
  if (r == 0) r = hopper::encode_tiled(&mw, w, dtype, 2, dw, &sw, bw, swz);
  if (r == 0) r = hopper::encode_tiled(&mo, out, dtype, 4, dout, so, bo, swz);
  if (r != 0) return hopper::kTensorMapError + r;
  auto kernel = bi_conv_wgmma_kernel<T, BN>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = biw::allow_smem(kernel, C::BYTES, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), (n + BN - 1) / BN, batch);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(mx, mw, mo, static_cast<const T*>(bias), n, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* x, const void* w, const void* bias, void* out, int batch,
                  const ConvShape& s, int n, int dtype, int route, cudaStream_t stream) {
  if (route == kRouteMma) {
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
  // the wgmma routes: stride 1, 64-channel boxes, 16-byte strides and bases
  if (s.sh != 1 || s.sw != 1 || s.c % biw::BK != 0 || n % 8 != 0 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case kRouteWgmma128x128: return launch_wgmma<T, 128>(x, w, bias, out, batch, s, n, dtype, stream);
    case kRouteWgmma128x64: return launch_wgmma<T, 64>(x, w, bias, out, batch, s, n, dtype, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- f32, Cout <= 8: the narrow direct kernel ----------------------------------

constexpr int NARROW_PIXELS = 128;  // output pixels (threads) of a block row: a row segment
// the narrow kernel's shared memory at most (ops/batch_invariant.py's NARROW_SMEM)
constexpr int NARROW_SMEM_MAX = 96 * 1024;
constexpr int NARROW_ROWS = 2;      // output rows of a block, each staged input row serving both

// Shared memory of the narrow kernel: W [K][CP], then one input row segment
// [NARROW_PIXELS + kw - 1 pixels][Cin + 4] (the 4 pad floats put the 16-byte
// reads of eight neighbouring threads on 32 different banks).
inline int narrow_smem_bytes(const ConvShape& s, int cp) {
  return 4 * (s.kh * s.kw * s.c * cp + (NARROW_PIXELS + s.kw - 1) * (s.c + 4));
}

// Output rows oh0, oh0 + 1 of a 128-pixel segment: input row j = 0 ..
// kh + NARROW_ROWS - 2 (ih = oh0 - pt + j) is staged once and feeds tap
// r = j - i of each output row i it reaches, so each output's taps still
// come in the (kh, kw, cin) order.
template <int CP>
__global__ void __launch_bounds__(NARROW_PIXELS)
    bi_conv_narrow_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out, ConvShape s,
                          int n) {
  extern __shared__ float4 narrow_smem[];
  float* ws = reinterpret_cast<float*>(narrow_smem);
  const int k = s.kh * s.kw * s.c, ld = s.c + 4, c4 = s.c / 4;
  float* xs = ws + k * CP;
  const int z = blockIdx.z, oh0 = blockIdx.y * NARROW_ROWS, ow0 = blockIdx.x * NARROW_PIXELS;
  const int tid = threadIdx.x;
  for (int e = tid; e < k * CP; e += NARROW_PIXELS) {
    const int kk = e / CP, co = e - kk * CP;
    ws[e] = co < n ? w[static_cast<int64_t>(co) * k + kk] : 0.f;
  }
  const float* xz = x + static_cast<int64_t>(z) * s.h * s.w * s.c;
  const int staged = (NARROW_PIXELS + s.kw - 1) * c4;  // float4s of one row segment
  float acc[NARROW_ROWS][CP];
#pragma unroll
  for (int i = 0; i < NARROW_ROWS; ++i)
#pragma unroll
    for (int co = 0; co < CP; ++co) acc[i][co] = 0.f;
  for (int j = 0; j < s.kh + NARROW_ROWS - 1; ++j) {
    const int ih = oh0 - s.pt + j;
    const bool row_in = ih >= 0 && ih < s.h;
    __syncthreads();  // every thread is done with the previous row
    // four 16-byte loads in flight a thread, then their stores
    for (int e0 = tid; e0 < staged; e0 += 4 * NARROW_PIXELS) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NARROW_PIXELS, p = e / c4, c = (e - p * c4) * 4;
        const int iw = ow0 - s.pl + p;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < staged && row_in && iw >= 0 && iw < s.w)
          v[u] = *reinterpret_cast<const float4*>(xz + (static_cast<int64_t>(ih) * s.w + iw) * s.c + c);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NARROW_PIXELS, p = e / c4, c = (e - p * c4) * 4;
        if (e < staged) *reinterpret_cast<float4*>(xs + p * ld + c) = v[u];
      }
    }
    __syncthreads();  // the row (and, for j = 0, W) is in
    for (int q = 0; q < s.kw; ++q) {
      const float* xp = xs + (tid + q) * ld;
      for (int c = 0; c < s.c; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(xp + c);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < NARROW_ROWS; ++i) {
          const int r = j - i;  // this row's tap for output row i
          if (r < 0 || r >= s.kh) continue;
          const float* wp = ws + ((r * s.kw + q) * s.c + c) * CP;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int jj = 0; jj < CP; jj += 4) {
              const float4 wv = *reinterpret_cast<const float4*>(wp + t * CP + jj);
              acc[i][jj + 0] = fmaf(xv[t], wv.x, acc[i][jj + 0]);
              acc[i][jj + 1] = fmaf(xv[t], wv.y, acc[i][jj + 1]);
              acc[i][jj + 2] = fmaf(xv[t], wv.z, acc[i][jj + 2]);
              acc[i][jj + 3] = fmaf(xv[t], wv.w, acc[i][jj + 3]);
            }
          }
        }
      }
    }
  }
  const int ow = ow0 + tid;
  if (ow >= s.ow) return;
#pragma unroll
  for (int i = 0; i < NARROW_ROWS; ++i) {
    if (oh0 + i >= s.oh) break;
    float* o = out + ((static_cast<int64_t>(z) * s.oh + oh0 + i) * s.ow + ow) * n;
#pragma unroll
    for (int co = 0; co < CP; ++co)
      if (co < n) o[co] = acc[i][co] + (bias != nullptr ? bias[co] : 0.f);
  }
}

template <int CP>
static int launch_narrow(const float* x, const float* w, const float* bias, float* out,
                         int batch, const ConvShape& s, int n, cudaStream_t stream) {
  const int bytes = narrow_smem_bytes(s, CP);
  if (bytes > NARROW_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bi_conv_narrow_kernel<CP>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = biw::allow_smem(kernel, NARROW_SMEM_MAX, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.ow + NARROW_PIXELS - 1) / NARROW_PIXELS,
                  (s.oh + NARROW_ROWS - 1) / NARROW_ROWS, batch);
  kernel<<<grid, NARROW_PIXELS, bytes, stream>>>(x, w, bias, out, s, n);
  return static_cast<int>(cudaGetLastError());
}

static int launch_f32(const void* x, const void* w, const void* bias, void* out, int batch,
                      const ConvShape& s, int n, int route, cudaStream_t stream) {
  const float *xf = static_cast<const float*>(x), *wf = static_cast<const float*>(w),
              *bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (route == kRouteFma) {
    const dim3 grid((s.oh * s.ow + bi::FM - 1) / bi::FM, (n + bi::FN - 1) / bi::FN, batch);
    bi_conv_fma_kernel<<<grid, bi::THREADS, 0, stream>>>(xf, wf, bf, of, s, n);
    return static_cast<int>(cudaGetLastError());
  }
  // the narrow route: stride 1, 16-byte input rows, at most 8 outputs
  if (route != kRouteNarrow || s.sh != 1 || s.sw != 1 || s.c % 4 != 0 || n > 8 ||
      (s.oh + NARROW_ROWS - 1) / NARROW_ROWS > 65535 || !aligned16(x))
    return static_cast<int>(cudaErrorInvalidValue);
  return n <= 4 ? launch_narrow<4>(xf, wf, bf, of, batch, s, n, stream)
                : launch_narrow<8>(xf, wf, bf, of, batch, s, n, stream);
}

// x [batch, h, w, cin], w [cout, kh, kw, cin], bias [cout] or null, out
// [batch, oh, ow, cout]; all of one dtype, contiguous. pt / pl: the top and
// left zero padding; the bottom and right follow from oh, ow. route:
// conv_route's code (bi_wgmma.cuh's BiRoute); a route that does not take
// this dtype or geometry is an error, never a fallback.
extern "C" int bi_conv(const void* x, const void* w, const void* bias, void* out, int batch,
                       int h, int w_in, int cin, int oh, int ow, int cout, int kh, int kw, int sh,
                       int sw, int pt, int pl, int dtype, int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || batch > 65535 || oh <= 0 || ow <= 0 || cout <= 0 || cin <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape s{h, w_in, cin, oh, ow, kh, kw, sh, sw, pt, pl};
  switch (dtype) {
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, bias, out, batch, s, cout, dtype, route, st);
    case kFloat16:
      return launch<__half>(x, w, bias, out, batch, s, cout, dtype, route, st);
    case kFloat32:
      return launch_f32(x, w, bias, out, batch, s, cout, route, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
