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
// flop/byte balance point. The forward is a grid-stride elementwise pass
// with 16-byte loads of both halves, 16-byte stores, f32 math, and nothing
// kept between elements; the backward (geglu_bwd_kernel) gives each thread
// several rows' vectors, all loaded before the math.
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

// The cheaper gelu_tanh for 16-bit outputs, without tanh: with
// sg = sigmoid(2u) = 1 / (1 + e), e = exp(-2u), u = C (x + 0.044715 x^3),
//   1 + tanh(u) = 2 sg,   1 - tanh(u)^2 = 4 sg (1 - sg) = 4 sg^2 e,
// so gelu = x sg and gelu' = sg + 2 x sg^2 e C (1 + 3 0.044715 x^2), with no
// cancellation at either tail (1 - sg is computed as sg e). ex2.approx and
// rcp.approx are a few f32 ulps from exact, far below a bf16 or f16 ulp; an
// e that overflows gives sg = 0 and a 0 derivative, as the limit is.
__device__ __forceinline__ void gelu_tanh_fast(float x, float& gelu, float& grad) {
  constexpr float C = 0.7978845608028654f;
  constexpr float M2LOG2E = -2.0f * 1.4426950408889634f;
  const float u = C * (x + 0.044715f * (x * x * x));
  float e, sg;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(u * M2LOG2E));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(sg) : "f"(1.0f + e));
  gelu = x * sg;
  const float se = sg * e;  // 1 - sg
  grad = sg + 2.0f * x * sg * (e == INFINITY ? 0.0f : se) * C * (1.0f + 3 * 0.044715f * x * x);
}

// B9: a block of kBwdThreads threads over kBwdRows rows, each thread one
// 16-byte column vector of every row (blockIdx.y steps the vectors past
// kBwdThreads). A thread issues all 3 x kBwdRows loads (gate, val, dout of
// each row) before any math, and the row and column offsets are one
// multiply each: no division, no loop; the grid covers the rows once. f32
// keeps tanhf (its limit is 1e-5); 16-bit outputs take gelu_tanh_fast. Two
// rows a thread beat four (64 registers against 121 in bf16; 0.0569 against
// 0.0603 ms at [16, 1024, 2048] on an NVIDIA H100 80GB HBM3 at 700 W,
// scripts/flash_ab.py).
constexpr int kBwdThreads = 128, kBwdRows = 2;

template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
geglu_bwd_kernel(const T* __restrict__ proj, const T* __restrict__ dout, T* __restrict__ dproj,
                 int64_t rows, int f) {
  const int cv = blockIdx.y * kBwdThreads + threadIdx.x;
  if (cv * VEC >= f) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kBwdRows;
  const int64_t c = static_cast<int64_t>(cv) * VEC;
  Vec<T, VEC> g[kBwdRows], v[kBwdRows], d[kBwdRows];
#pragma unroll
  for (int k = 0; k < kBwdRows; ++k) {
    if (r0 + k >= rows) continue;
    const int64_t row = (r0 + k) * 2 * static_cast<int64_t>(f);
    g[k] = load_vec<T, VEC>(proj + row + c);
    v[k] = load_vec<T, VEC>(proj + row + f + c);
    d[k] = load_vec<T, VEC>(dout + (r0 + k) * f + c);
  }
#pragma unroll
  for (int k = 0; k < kBwdRows; ++k) {
    if (r0 + k >= rows) continue;
    Vec<T, VEC> dg, dv;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float df = to_f32(d[k].v[e]);
      float gelu, grad;
      if constexpr (sizeof(T) == 4) {
        gelu_tanh(to_f32(g[k].v[e]), gelu, grad);
      } else {
        gelu_tanh_fast(to_f32(g[k].v[e]), gelu, grad);
      }
      dg.v[e] = from_f32<T>(df * to_f32(v[k].v[e]) * grad);
      dv.v[e] = from_f32<T>(df * gelu);
    }
    const int64_t row = (r0 + k) * 2 * static_cast<int64_t>(f);
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

template <typename T, int VEC>
static int launch_bwd_vec(const void* proj, const void* dout, void* dproj, int64_t rows, int f,
                          cudaStream_t stream) {
  const int vecs = f / VEC;
  const dim3 grid(static_cast<unsigned>((rows + kBwdRows - 1) / kBwdRows),
                  (vecs + kBwdThreads - 1) / kBwdThreads);
  geglu_bwd_kernel<T, VEC><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(dout), static_cast<T*>(dproj), rows, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_bwd(const void* proj, const void* dout, void* dproj, int64_t rows, int f,
                      cudaStream_t stream) {
  constexpr int V = vec16<T>();
  if (f % V == 0 && aligned16(proj) && aligned16(dout) && aligned16(dproj))
    return launch_bwd_vec<T, V>(proj, dout, dproj, rows, f, stream);
  return launch_bwd_vec<T, 1>(proj, dout, dproj, rows, f, stream);
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
