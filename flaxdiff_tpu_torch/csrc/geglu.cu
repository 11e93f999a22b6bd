// GEGLU forward: out = val * gelu_tanh(gate) over a packed [rows, 2F]
// projection, gate = proj[:, :F], val = proj[:, F:].
//
// Replaces the TPU kernel `_geglu_kernel` (flaxdiff_tpu/ops/fused_adaln.py:500,
// launched at :538), which streams the two halves as separate lane blocks.
//
// Bound on the H100: bytes. Each element is read once and each output
// written once (4F bytes in, 2F out per row in bf16) against a handful of
// flops, far below the card's ~295 flop/byte balance point. The design is
// therefore a grid-stride elementwise pass with 16-byte loads of both halves
// and a 16-byte store, f32 math, and nothing kept between elements.
#include "common.cuh"

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
      // jax.nn.gelu(approximate=True), as fused_adaln.py:486-490 writes it
      const float inner = 0.7978845608028654f * (gf + 0.044715f * (gf * gf * gf));
      const float gelu = 0.5f * gf * (1.0f + tanhf(inner));
      o.v[k] = from_f32<T>(vf * gelu);
    }
    store_vec<T, VEC>(out + r * static_cast<int64_t>(f) + c, o);
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
