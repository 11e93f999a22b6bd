// GEGLU over a packed [rows, 2F] projection, gate = proj[:, :F],
// val = proj[:, F:]. Forward: out = val * gelu_tanh(gate). Backward:
// dproj = [dout * val * gelu_tanh'(gate), dout * gelu_tanh(gate)], the
// gate's half first.
//
// Replaces the TPU kernels `_geglu_kernel` (flaxdiff_tpu/ops/fused_adaln.py:500,
// launched at :538) and `_geglu_bwd_kernel` (:506, launched at :572), which
// stream the two halves as separate lane blocks.
//
// Bound on the H100: bytes. Each element is read once and each output
// written once (forward: 4F bytes in, 2F out per row in bf16; backward: 6F
// in, 4F out) against a few tens of flops, far below the card's ~295
// flop/byte balance point. The design is therefore a grid-stride
// elementwise pass with 16-byte loads of both halves (and of dout), 16-byte
// stores, f32 math, and nothing kept between elements.
#include "common.cuh"

// jax.nn.gelu(approximate=True) and its derivative, as fused_adaln.py:486-497
// write them
__device__ __forceinline__ void gelu_tanh(float x, float& gelu, float& grad) {
  constexpr float C = 0.7978845608028654f;
  const float t = tanhf(C * (x + 0.044715f * (x * x * x)));
  gelu = 0.5f * x * (1.0f + t);
  grad = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * C * (1.0f + 3 * 0.044715f * x * x);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
geglu_kernel(const T* __restrict__ proj, T* __restrict__ out, int64_t rows, int f) {
  const int64_t vecs_per_row = f / VEC;
  const int64_t total = rows * vecs_per_row;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / vecs_per_row;
    const int64_t c = (i - r * vecs_per_row) * VEC;
    const T* row = proj + r * 2 * static_cast<int64_t>(f);
    const Vec<T, VEC> g = load_vec<T, VEC>(row + c);
    const Vec<T, VEC> v = load_vec<T, VEC>(row + f + c);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gf = to_f32(g.v[k]);
      const float vf = to_f32(v.v[k]);
      float gelu, grad;
      gelu_tanh(gf, gelu, grad);
      o.v[k] = from_f32<T>(vf * gelu);
    }
    store_vec<T, VEC>(out + r * static_cast<int64_t>(f) + c, o);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
geglu_bwd_kernel(const T* __restrict__ proj, const T* __restrict__ dout, T* __restrict__ dproj,
                 int64_t rows, int f) {
  const int64_t vecs_per_row = f / VEC;
  const int64_t total = rows * vecs_per_row;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / vecs_per_row;
    const int64_t c = (i - r * vecs_per_row) * VEC;
    const int64_t row = r * 2 * static_cast<int64_t>(f);
    const Vec<T, VEC> g = load_vec<T, VEC>(proj + row + c);
    const Vec<T, VEC> v = load_vec<T, VEC>(proj + row + f + c);
    const Vec<T, VEC> d = load_vec<T, VEC>(dout + r * static_cast<int64_t>(f) + c);
    Vec<T, VEC> dg, dv;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float df = to_f32(d.v[k]);
      float gelu, grad;
      gelu_tanh(to_f32(g.v[k]), gelu, grad);
      dg.v[k] = from_f32<T>(df * to_f32(v.v[k]) * grad);
      dv.v[k] = from_f32<T>(df * gelu);
    }
    store_vec<T, VEC>(dproj + row + c, dg);
    store_vec<T, VEC>(dproj + row + f + c, dv);
  }
}

template <typename T>
static int launch(const void* proj, void* out, int64_t rows, int f, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const T* p = static_cast<const T*>(proj);
  T* o = static_cast<T*>(out);
  const int threads = 256;
  if (f % V == 0 && aligned16(proj) && aligned16(out)) {
    geglu_kernel<T, V><<<grid_for(rows * (f / V), threads), threads, 0, stream>>>(p, o, rows, f);
  } else {
    geglu_kernel<T, 1><<<grid_for(rows * f, threads), threads, 0, stream>>>(p, o, rows, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int geglu_fwd(const void* proj, void* out, int64_t rows, int f, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(proj, out, rows, f, s);
    case kBFloat16: return launch<__nv_bfloat16>(proj, out, rows, f, s);
    case kFloat16: return launch<__half>(proj, out, rows, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
static int launch_bwd(const void* proj, const void* dout, void* dproj, int64_t rows, int f,
                      cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const T* p = static_cast<const T*>(proj);
  const T* d = static_cast<const T*>(dout);
  T* o = static_cast<T*>(dproj);
  const int threads = 256;
  if (f % V == 0 && aligned16(proj) && aligned16(dout) && aligned16(dproj)) {
    geglu_bwd_kernel<T, V><<<grid_for(rows * (f / V), threads), threads, 0, stream>>>(p, d, o,
                                                                                      rows, f);
  } else {
    geglu_bwd_kernel<T, 1><<<grid_for(rows * f, threads), threads, 0, stream>>>(p, d, o, rows, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int geglu_bwd(const void* proj, const void* dout, void* dproj, int64_t rows, int f,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_bwd<float>(proj, dout, dproj, rows, f, s);
    case kBFloat16: return launch_bwd<__nv_bfloat16>(proj, dout, dproj, rows, f, s);
    case kFloat16: return launch_bwd<__half>(proj, dout, dproj, rows, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
