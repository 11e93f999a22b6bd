// Fused GroupNorm + SiLU forward over channels-last [B, HW, C] activations,
// in two kernels with a small finalize between them (done by the wrapper).
//
// Replaces the TPU kernels `_gn_stats_kernel` (flaxdiff_tpu/ops/fused_norm.py:58,
// launched at :285) and `_gn_norm_kernel` (:85, launched at :314).
//
// Bound on the H100: bytes. The function must read x once for the statistics
// and once more to normalize, and write the output once; the arithmetic per
// element is a few flops. The design keeps every load coalesced along C
// (contiguous in channels-last) with 16-byte vectors, and splits HW into
// blocks so that B x nblk blocks fill the 132 SMs (B x G = 16 blocks, one per
// group, would leave most of the card idle).
//
// Pass 1 (gn_stats): grid (nblk, B). Each block owns `rows_per_block` rows of
// one sample and writes, per group, the sum and the second moment shifted
// around the block's own group mean, as fused_norm.py:74-81 does. The wrapper
// merges the blocks with the Welford/Chan rule (fused_norm.py:295-311), so a
// large mean never cancels against E[x^2]. The block reads its rows twice;
// the second read comes from L2.
//
// Pass 2 (gn_norm): a grid-stride elementwise pass computing
// silu((x - mean) * rstd * scale + bias) in f32 and storing the input dtype.
#include "common.cuh"

// Sums per-thread channel partials (`acc`, VEC channels per thread) into
// csum[c] in a fixed order, so the result does not depend on scheduling.
// Thread t owns channel vector t % nvec; threads t and t + nvec share it.
template <int VEC>
__device__ __forceinline__ void reduce_channels(const float (&acc)[VEC], float* part,
                                                float* csum, int c, int nvec, int rows_per_iter) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) part[tid * VEC + k] = acc[k];
  __syncthreads();
  for (int ch = tid; ch < c; ch += blockDim.x) {
    const int cv = ch / VEC, k = ch - cv * VEC;
    float s = 0.f;
    for (int j = 0; j < rows_per_iter; ++j) s += part[(j * nvec + cv) * VEC + k];
    csum[ch] = s;
  }
  __syncthreads();
}

template <typename T, int VEC>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int hw,
                                int c, int groups, int rows_per_block) {
  extern __shared__ float smem[];
  const int nvec = c / VEC;
  const int rows_per_iter = blockDim.x / nvec;
  float* part = smem;                        // [blockDim.x * VEC]
  float* csum = part + blockDim.x * VEC;     // [c]
  float* gsum = csum + c;                    // [groups]
  float* gmean = gsum + groups;              // [groups]

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int tid = threadIdx.x;
  const int cv = tid % nvec, r_off = tid / nvec;
  const int row_begin = blk * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, hw);
  const int cg = c / groups;
  const T* xb = x + static_cast<int64_t>(b) * hw * c + cv * VEC;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int r = row_begin + r_off; r < row_end; r += rows_per_iter) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xb + static_cast<int64_t>(r) * c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += to_f32(v.v[k]);
  }
  reduce_channels<VEC>(acc, part, csum, c, nvec, rows_per_iter);
  const float count = static_cast<float>((row_end - row_begin) * cg);
  if (tid < groups) {
    float s = 0.f;
    for (int j = 0; j < cg; ++j) s += csum[tid * cg + j];
    gsum[tid] = s;
    gmean[tid] = s / count;
  }
  __syncthreads();

  // shifted second moment around this block's group means
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int r = row_begin + r_off; r < row_end; r += rows_per_iter) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xb + static_cast<int64_t>(r) * c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = to_f32(v.v[k]) - gmean[(cv * VEC + k) / cg];
      acc[k] += d * d;
    }
  }
  reduce_channels<VEC>(acc, part, csum, c, nvec, rows_per_iter);
  if (tid < groups) {
    float s = 0.f;
    for (int j = 0; j < cg; ++j) s += csum[tid * cg + j];
    float* out = partial + (static_cast<int64_t>(b) * nblk + blk) * 2 * groups;
    out[tid] = gsum[tid];
    out[groups + tid] = s;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
gn_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int64_t hw, int c,
               int groups, int apply_silu, int64_t total_vecs) {
  const int nvec = c / VEC;
  const int cg = c / groups;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total_vecs;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / (hw * nvec);
    const int c0 = static_cast<int>(i % nvec) * VEC;
    const Vec<T, VEC> v = load_vec<T, VEC>(x + i * VEC);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = c0 + k;
      const int64_t bg = b * groups + ch / cg;
      float y = (to_f32(v.v[k]) - mean[bg]) * rstd[bg];
      y = y * scale[ch] + bias[ch];
      if (apply_silu) y = y * (1.0f / (1.0f + expf(-y)));
      o.v[k] = from_f32<T>(y);
    }
    store_vec<T, VEC>(out + i * VEC, o);
  }
}

// Threads per stats block: a whole number of rows of channel vectors.
static int stats_threads(int nvec) {
  if (nvec > 1024) return 0;
  if (nvec >= 256) return nvec;
  return (256 / nvec) * nvec;
}

template <typename T, int VEC>
static int launch_stats(const void* x, float* partial, int batch, int hw, int c, int groups,
                        int rows_per_block, cudaStream_t stream) {
  const int nvec = c / VEC;
  const int threads = stats_threads(nvec);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (hw + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * (static_cast<size_t>(threads) * VEC + c + 2 * groups);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  gn_stats_kernel<T, VEC><<<dim3(nblk, batch), threads, smem, stream>>>(
      static_cast<const T*>(x), partial, hw, c, groups, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int stats_dispatch(const void* x, float* partial, int batch, int hw, int c, int groups,
                          int rows_per_block, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  if (c % V == 0 && aligned16(x))
    return launch_stats<T, V>(x, partial, batch, hw, c, groups, rows_per_block, stream);
  return launch_stats<T, 1>(x, partial, batch, hw, c, groups, rows_per_block, stream);
}

template <typename T>
static int norm_dispatch(const void* x, const float* mean, const float* rstd, const float* scale,
                         const float* bias, void* out, int batch, int hw, int c, int groups,
                         int apply_silu, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const int threads = 256;
  const int64_t elems = static_cast<int64_t>(batch) * hw * c;
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (c % V == 0 && aligned16(x) && aligned16(out)) {
    gn_norm_kernel<T, V><<<grid_for(elems / V, threads), threads, 0, stream>>>(
        xi, mean, rstd, scale, bias, o, hw, c, groups, apply_silu, elems / V);
  } else {
    gn_norm_kernel<T, 1><<<grid_for(elems, threads), threads, 0, stream>>>(
        xi, mean, rstd, scale, bias, o, hw, c, groups, apply_silu, elems);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gn_stats(const void* x, float* partial, int batch, int hw, int c, int groups,
                        int rows_per_block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return stats_dispatch<float>(x, partial, batch, hw, c, groups, rows_per_block, s);
    case kBFloat16:
      return stats_dispatch<__nv_bfloat16>(x, partial, batch, hw, c, groups, rows_per_block, s);
    case kFloat16: return stats_dispatch<__half>(x, partial, batch, hw, c, groups, rows_per_block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gn_norm(const void* x, const float* mean, const float* rstd, const float* scale,
                       const float* bias, void* out, int batch, int hw, int c, int groups,
                       int apply_silu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return norm_dispatch<float>(x, mean, rstd, scale, bias, out, batch, hw, c, groups, apply_silu, s);
    case kBFloat16:
      return norm_dispatch<__nv_bfloat16>(x, mean, rstd, scale, bias, out, batch, hw, c, groups,
                                          apply_silu, s);
    case kFloat16:
      return norm_dispatch<__half>(x, mean, rstd, scale, bias, out, batch, hw, c, groups, apply_silu, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
