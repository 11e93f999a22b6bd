// The DiT epilogues over [B, L, C] tokens with per-sample [B, 1, C]
// modulators (AdaLN-Zero):
//   ln_mod_fwd    LayerNorm without affine (fast variance, clamped at 0), then
//                 xhat * (1 + s_i) + b_i for one or two views, f32 out; saves
//                 the per-row mean and rstd
//   ln_mod_bwd    dx from the saved statistics, plus per-(sample, row block)
//                 f32 partials of sum g_i and sum g_i * xhat for each view
//   gate_res_fwd  x + gate * h in the native dtype
//   gate_res_bwd  dh = gate * dO in the native dtype, plus per-block f32
//                 partials of sum_L dO * h
//
// Replaces the TPU kernels `_ln_mod_kernel` (flaxdiff_tpu/ops/fused_adaln.py:138,
// launched at :224), `_ln_mod_bwd_kernel` (:161, at :263), `_gate_res_kernel`
// (:380, at :403) and `_gate_res_bwd_kernel` (:386, at :444).
//
// Bound on the H100: bytes. Each is a row pass doing a few flops an element,
// far below the card's ~295 flop/byte balance point. The TPU sized its row
// blocks to a VMEM budget; here a warp owns a row of C (768 for DiT-B) for
// the row reductions, every access is 16 bytes where C and the pointers
// allow (a scalar path takes the rest), and the math is f32. The backward
// column sums (the modulators' and the gate's gradients) are per-block
// partials over ADALN_ROWS rows, written in a fixed order and summed by a
// short torch finalize, so the gradients are deterministic: no atomics.
//
// Rounding follows the reference: the gated residual rounds the product to
// the token dtype and then the sum (bf16 `x + g * h` in XLA); in f32 the
// product and the sum are rounded apart (no FMA contraction), bit-equal to
// torch's `x + gate * h`.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 8;      // ln_mod_fwd: rows a block, one warp a row
constexpr int kBwdThreads = 256;  // ln_mod_bwd: 8 warps over the block's rows
constexpr int kGateThreads = 128; // gate_res_bwd: a thread per column vector

// Sum across the warp; every lane gets lane 0's total, so all lanes use
// the same value
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[V]) {
  const Vec<T, V> v = load_vec<T, V>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f32(v.v[k]);
}

// V floats to p, as 16-byte stores where V allows
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <typename T, int V>
__device__ __forceinline__ void xhat_of(const T* x, float mu, float rstd, float (&xh)[V]) {
  load_f32<T, V>(x, xh);
#pragma unroll
  for (int k = 0; k < V; ++k) xh[k] = (xh[k] - mu) * rstd;
}

template <typename T, int V>
__device__ __forceinline__ void modulate_store(float* out, const float (&xh)[V], const T* s,
                                               const T* b) {
  float sv[V], bv[V], o[V];
  load_f32<T, V>(s, sv);
  load_f32<T, V>(b, bv);
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = xh[k] * (1.0f + sv[k]) + bv[k];
  store_f32<V>(out, o);
}

// ---------------------------------------------------------------------------
// B10: LayerNorm + modulate, one warp a row (the generic path: any C)
// ---------------------------------------------------------------------------

template <typename T, int V, int NV>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_mod_fwd_kernel(const T* __restrict__ x, const T* __restrict__ s0, const T* __restrict__ b0,
                  const T* __restrict__ s1, const T* __restrict__ b1, float* __restrict__ v0,
                  float* __restrict__ v1, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int64_t rows, int L, int C, int64_t mod_stride,
                  float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = C / V;
  const T* xr = x + row * C;
  float sum = 0.0f, sq = 0.0f;
  for (int i = lane; i < nvec; i += 32) {
    float xv[V];
    load_f32<T, V>(xr + i * V, xv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sum += xv[k];
      sq += xv[k] * xv[k];
    }
  }
  const float mu = warp_total(sum) / C;
  const float var = fmaxf(warp_total(sq) / C - mu * mu, 0.0f);
  const float rstd = rsqrtf(var + eps);
  const int64_t m = (row / L) * mod_stride;
  for (int i = lane; i < nvec; i += 32) {
    const int c = i * V;
    float xh[V];
    xhat_of<T, V>(xr + c, mu, rstd, xh);
    modulate_store<T, V>(v0 + row * C + c, xh, s0 + m + c, b0 + m + c);
    if constexpr (NV == 2) modulate_store<T, V>(v1 + row * C + c, xh, s1 + m + c, b1 + m + c);
  }
  if (lane == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// The same pass at the DiT family's widths (C = 384, 768, 1024, 1152), C a
// template parameter: a lane's share of the row (NPL 16-byte vectors, 3 for
// bf16 at C = 768) is known at compile time, so the lane issues every load
// of its row before the reduction, x and the modulators of both views, and
// keeps them in registers: one read of x, no loop-carried load chain. The
// generic kernel above loops over a runtime C, reading a vector after the
// last one's sum, reads x again after the reduction and the modulators only
// then. Loading the modulators after the reduction instead (they are per
// sample, cache-resident) freed registers but lengthened each warp's chain:
// 0.0354 against 0.0296 ms at [32, 256, 768] with two views on an NVIDIA
// H100 80GB HBM3 at 700 W (scripts/flash_ab.py, PERF.md).
template <typename T, int C, int NV>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_mod_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ s0,
                       const T* __restrict__ b0, const T* __restrict__ s1,
                       const T* __restrict__ b1, float* __restrict__ v0, float* __restrict__ v1,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out, int64_t rows,
                       int L, int64_t mod_stride, float eps) {
  constexpr int V = vec16<T>();
  constexpr int NVEC = C / V, NPL = (NVEC + 31) / 32;
  static_assert(C % V == 0, "whole 16-byte vectors");
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  // vector lane + 32 k of the row; only the last k can fall past C
  const bool tail = NVEC % 32 == 0 || lane + 32 * (NPL - 1) < NVEC;
  const T* xr = x + row * C;
  const int64_t m = (row / L) * mod_stride;
  Vec<T, V> xv[NPL], sv[NV][NPL], bv[NV][NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (k == NPL - 1 && !tail) continue;
    const int c = (lane + 32 * k) * V;
    xv[k] = load_vec<T, V>(xr + c);
    sv[0][k] = load_vec<T, V>(s0 + m + c);
    bv[0][k] = load_vec<T, V>(b0 + m + c);
    if constexpr (NV == 2) {
      sv[1][k] = load_vec<T, V>(s1 + m + c);
      bv[1][k] = load_vec<T, V>(b1 + m + c);
    }
  }
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    if (k == NPL - 1 && !tail) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_f32(xv[k].v[e]);
      sum += f;
      sq += f * f;
    }
  }
  const float mu = warp_total(sum) / C;
  const float var = fmaxf(warp_total(sq) / C - mu * mu, 0.0f);
  const float rstd = rsqrtf(var + eps);
  // a view at a time (the loop the other way round spilled 12 bytes at C =
  // 1024 with two views)
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float* out = (i == 0 ? v0 : v1) + row * C;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      if (k == NPL - 1 && !tail) continue;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = (to_f32(xv[k].v[e]) - mu) * rstd * (1.0f + to_f32(sv[i][k].v[e])) +
               to_f32(bv[i][k].v[e]);
      store_f32<V>(out + (lane + 32 * k) * V, o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

// ---------------------------------------------------------------------------
// B11: LayerNorm + modulate backward, a block per (row block, sample)
// ---------------------------------------------------------------------------

// dxhat = sum_i g_i * (1 + s_i) for V consecutive columns
template <typename T, int V, int NV>
__device__ __forceinline__ void dxhat_of(const float* g0, const float* g1, const T* s0,
                                         const T* s1, float (&d)[V]) {
  float g[V], s[V];
  load_f32<float, V>(g0, g);
  load_f32<T, V>(s0, s);
#pragma unroll
  for (int k = 0; k < V; ++k) d[k] = g[k] * (1.0f + s[k]);
  if constexpr (NV == 2) {
    load_f32<float, V>(g1, g);
    load_f32<T, V>(s1, s);
#pragma unroll
    for (int k = 0; k < V; ++k) d[k] += g[k] * (1.0f + s[k]);
  }
}

template <typename T, int V, int G, int NV>
__global__ void __launch_bounds__(kBwdThreads)
ln_mod_bwd_kernel(const T* __restrict__ x, const T* __restrict__ s0, const T* __restrict__ s1,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  const float* __restrict__ g0, const float* __restrict__ g1, T* __restrict__ dx,
                  float* __restrict__ partials, int L, int C, int64_t mod_stride,
                  int rows_per_block) {
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int64_t b = blockIdx.y;
  const int r0 = blk * rows_per_block;
  const int r1 = min(r0 + rows_per_block, L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* sb0 = s0 + b * mod_stride;
  const T* sb1 = s1 + b * mod_stride;

  // dx: a warp a row; row reductions as in the TPU kernel
  const int nvec = C / V;
  for (int r = r0 + warp; r < r1; r += kBwdThreads / 32) {
    const int64_t off = (b * L + r) * C;
    const float mu = mean[b * L + r], rs = rstd[b * L + r];
    float m1 = 0.0f, m2 = 0.0f;
    for (int i = lane; i < nvec; i += 32) {
      const int c = i * V;
      float xh[V], d[V];
      xhat_of<T, V>(x + off + c, mu, rs, xh);
      dxhat_of<T, V, NV>(g0 + off + c, g1 + off + c, sb0 + c, sb1 + c, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        m1 += d[k];
        m2 += d[k] * xh[k];
      }
    }
    m1 = warp_total(m1) / C;
    m2 = warp_total(m2) / C;
    for (int i = lane; i < nvec; i += 32) {
      const int c = i * V;
      float xh[V], d[V];
      xhat_of<T, V>(x + off + c, mu, rs, xh);
      dxhat_of<T, V, NV>(g0 + off + c, g1 + off + c, sb0 + c, sb1 + c, d);
      Vec<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) out.v[k] = from_f32<T>(rs * (d[k] - m1 - xh[k] * m2));
      store_vec<T, V>(dx + off + c, out);
    }
  }

  // column partials: a thread per G columns, down the block's rows in order;
  // [db_0, ds_0, db_1, ds_1] as the TPU kernel stacks them
  float* pout = partials + (b * nblk + blk) * (2 * NV) * static_cast<int64_t>(C);
  for (int cg = threadIdx.x; cg < C / G; cg += kBwdThreads) {
    const int c = cg * G;
    float acc[2 * NV][G];
#pragma unroll
    for (int j = 0; j < 2 * NV; ++j)
#pragma unroll
      for (int k = 0; k < G; ++k) acc[j][k] = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const int64_t off = (b * L + r) * C + c;
      float xh[G], g[G];
      xhat_of<T, G>(x + off, mean[b * L + r], rstd[b * L + r], xh);
      load_f32<float, G>(g0 + off, g);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        acc[0][k] += g[k];
        acc[1][k] += g[k] * xh[k];
      }
      if constexpr (NV == 2) {
        load_f32<float, G>(g1 + off, g);
#pragma unroll
        for (int k = 0; k < G; ++k) {
          acc[2][k] += g[k];
          acc[3][k] += g[k] * xh[k];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * NV; ++j) store_f32<G>(pout + j * static_cast<int64_t>(C) + c, acc[j]);
  }
}

// ---------------------------------------------------------------------------
// B12, B13: gated residual
// ---------------------------------------------------------------------------

// gate * h rounded to T, as the reference's native-dtype product
template <typename T>
__device__ __forceinline__ float native_product(float g, float h) {
  return to_f32(from_f32<T>(__fmul_rn(g, h)));
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
gate_res_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gate, const T* __restrict__ h,
                    T* __restrict__ out, int64_t rows, int L, int C, int64_t gate_stride) {
  const int64_t vecs_per_row = C / V;
  const int64_t total = rows * vecs_per_row;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / vecs_per_row;
    const int64_t c = (i - r * vecs_per_row) * V;
    float xv[V], gv[V], hv[V];
    load_f32<T, V>(x + r * C + c, xv);
    load_f32<T, V>(gate + (r / L) * gate_stride + c, gv);
    load_f32<T, V>(h + r * C + c, hv);
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = from_f32<T>(__fadd_rn(xv[k], native_product<T>(gv[k], hv[k])));
    store_vec<T, V>(out + r * C + c, o);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kGateThreads)
gate_res_bwd_kernel(const T* __restrict__ gate, const T* __restrict__ h,
                    const T* __restrict__ dout, T* __restrict__ dh, float* __restrict__ partials,
                    int L, int C, int64_t gate_stride, int rows_per_block) {
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int64_t b = blockIdx.y;
  const int r0 = blk * rows_per_block;
  const int r1 = min(r0 + rows_per_block, L);
  float* pout = partials + (b * nblk + blk) * static_cast<int64_t>(C);
  for (int cg = threadIdx.x; cg < C / V; cg += kGateThreads) {
    const int c = cg * V;
    float gv[V], acc[V];
    load_f32<T, V>(gate + b * gate_stride + c, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const int64_t off = (b * L + r) * C + c;
      float hv[V], dv[V];
      load_f32<T, V>(h + off, hv);
      load_f32<T, V>(dout + off, dv);
      Vec<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        o.v[k] = from_f32<T>(__fmul_rn(gv[k], dv[k]));
        acc[k] = fmaf(dv[k], hv[k], acc[k]);
      }
      store_vec<T, V>(dh + off, o);
    }
    store_f32<V>(pout + c, acc);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int V>
int launch_ln_fwd(const void* x, const void* s0, const void* b0, const void* s1, const void* b1,
                  void* v0, void* v1, void* mean, void* rstd, int64_t rows, int L, int C,
                  int64_t mod_stride, int nviews, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowWarps - 1) / kRowWarps;
  const T *xp = static_cast<const T*>(x), *s0p = static_cast<const T*>(s0),
          *b0p = static_cast<const T*>(b0), *s1p = static_cast<const T*>(s1),
          *b1p = static_cast<const T*>(b1);
  float *v0p = static_cast<float*>(v0), *v1p = static_cast<float*>(v1),
        *mp = static_cast<float*>(mean), *rp = static_cast<float*>(rstd);
  if (nviews == 2) {
    ln_mod_fwd_kernel<T, V, 2><<<blocks, kRowWarps * 32, 0, stream>>>(
        xp, s0p, b0p, s1p, b1p, v0p, v1p, mp, rp, rows, L, C, mod_stride, eps);
  } else {
    ln_mod_fwd_kernel<T, V, 1><<<blocks, kRowWarps * 32, 0, stream>>>(
        xp, s0p, b0p, s1p, b1p, v0p, v1p, mp, rp, rows, L, C, mod_stride, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_ln_fwd_rows(const void* x, const void* s0, const void* b0, const void* s1,
                       const void* b1, void* v0, void* v1, void* mean, void* rstd, int64_t rows,
                       int L, int64_t mod_stride, int nviews, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowWarps - 1) / kRowWarps;
  auto kernel = nviews == 2 ? ln_mod_fwd_rows_kernel<T, C, 2> : ln_mod_fwd_rows_kernel<T, C, 1>;
  kernel<<<blocks, kRowWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s0), static_cast<const T*>(b0),
      static_cast<const T*>(s1), static_cast<const T*>(b1), static_cast<float*>(v0),
      static_cast<float*>(v1), static_cast<float*>(mean), static_cast<float*>(rstd), rows, L,
      mod_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ln_fwd_typed(const void* x, const void* s0, const void* b0, const void* s1, const void* b1,
                 void* v0, void* v1, void* mean, void* rstd, int64_t rows, int L, int C,
                 int64_t mod_stride, int nviews, float eps, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const bool vec = C % V == 0 && mod_stride % V == 0 && aligned16(x) && aligned16(s0) &&
                   aligned16(b0) && aligned16(s1) && aligned16(b1) && aligned16(v0) &&
                   aligned16(v1);
  // the DiT family's widths (DiT-S, -B, -L, -XL) take the compile-time rows
#define FLAXDIFF_LN_ROWS(WIDTH)                                                               \
  case WIDTH:                                                                                 \
    return launch_ln_fwd_rows<T, WIDTH>(x, s0, b0, s1, b1, v0, v1, mean, rstd, rows, L,       \
                                        mod_stride, nviews, eps, stream);
  if (vec) {
    switch (C) {
      FLAXDIFF_LN_ROWS(384)
      FLAXDIFF_LN_ROWS(768)
      FLAXDIFF_LN_ROWS(1024)
      FLAXDIFF_LN_ROWS(1152)
      default: break;
    }
  }
#undef FLAXDIFF_LN_ROWS
  if (vec) {
    return launch_ln_fwd<T, V>(x, s0, b0, s1, b1, v0, v1, mean, rstd, rows, L, C, mod_stride,
                               nviews, eps, stream);
  }
  return launch_ln_fwd<T, 1>(x, s0, b0, s1, b1, v0, v1, mean, rstd, rows, L, C, mod_stride,
                             nviews, eps, stream);
}

template <typename T, int V, int G>
int launch_ln_bwd(const void* x, const void* s0, const void* s1, const void* mean,
                  const void* rstd, const void* g0, const void* g1, void* dx, void* partials,
                  int B, int L, int C, int64_t mod_stride, int nviews, int rows_per_block,
                  cudaStream_t stream) {
  const dim3 grid((L + rows_per_block - 1) / rows_per_block, B);
  const T *xp = static_cast<const T*>(x), *s0p = static_cast<const T*>(s0),
          *s1p = static_cast<const T*>(s1);
  const float *mp = static_cast<const float*>(mean), *rp = static_cast<const float*>(rstd),
              *g0p = static_cast<const float*>(g0), *g1p = static_cast<const float*>(g1);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partials);
  if (nviews == 2) {
    ln_mod_bwd_kernel<T, V, G, 2><<<grid, kBwdThreads, 0, stream>>>(
        xp, s0p, s1p, mp, rp, g0p, g1p, dxp, pp, L, C, mod_stride, rows_per_block);
  } else {
    ln_mod_bwd_kernel<T, V, G, 1><<<grid, kBwdThreads, 0, stream>>>(
        xp, s0p, s1p, mp, rp, g0p, g1p, dxp, pp, L, C, mod_stride, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ln_bwd_typed(const void* x, const void* s0, const void* s1, const void* mean,
                 const void* rstd, const void* g0, const void* g1, void* dx, void* partials,
                 int B, int L, int C, int64_t mod_stride, int nviews, int rows_per_block,
                 cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const bool vec = C % V == 0 && mod_stride % V == 0 && aligned16(x) && aligned16(s0) &&
                   aligned16(s1) && aligned16(g0) && aligned16(g1) && aligned16(dx) &&
                   aligned16(partials);
  if (vec) {
    return launch_ln_bwd<T, V, 4>(x, s0, s1, mean, rstd, g0, g1, dx, partials, B, L, C,
                                  mod_stride, nviews, rows_per_block, stream);
  }
  return launch_ln_bwd<T, 1, 1>(x, s0, s1, mean, rstd, g0, g1, dx, partials, B, L, C,
                                mod_stride, nviews, rows_per_block, stream);
}

template <typename T>
int gate_fwd_typed(const void* x, const void* gate, const void* h, void* out, int64_t rows, int L,
                   int C, int64_t gate_stride, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const T *xp = static_cast<const T*>(x), *gp = static_cast<const T*>(gate),
          *hp = static_cast<const T*>(h);
  T* op = static_cast<T*>(out);
  if (C % V == 0 && gate_stride % V == 0 && aligned16(x) && aligned16(gate) && aligned16(h) &&
      aligned16(out)) {
    gate_res_fwd_kernel<T, V><<<grid_for(rows * (C / V), 256), 256, 0, stream>>>(
        xp, gp, hp, op, rows, L, C, gate_stride);
  } else {
    gate_res_fwd_kernel<T, 1><<<grid_for(rows * C, 256), 256, 0, stream>>>(
        xp, gp, hp, op, rows, L, C, gate_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gate_bwd_typed(const void* gate, const void* h, const void* dout, void* dh, void* partials,
                   int B, int L, int C, int64_t gate_stride, int rows_per_block,
                   cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const dim3 grid((L + rows_per_block - 1) / rows_per_block, B);
  const T *gp = static_cast<const T*>(gate), *hp = static_cast<const T*>(h),
          *dp = static_cast<const T*>(dout);
  T* dhp = static_cast<T*>(dh);
  float* pp = static_cast<float*>(partials);
  if (C % V == 0 && gate_stride % V == 0 && aligned16(gate) && aligned16(h) &&
      aligned16(dout) && aligned16(dh) && aligned16(partials)) {
    gate_res_bwd_kernel<T, V><<<grid, kGateThreads, 0, stream>>>(gp, hp, dp, dhp, pp, L, C,
                                                                 gate_stride, rows_per_block);
  } else {
    gate_res_bwd_kernel<T, 1><<<grid, kGateThreads, 0, stream>>>(gp, hp, dp, dhp, pp, L, C,
                                                                 gate_stride, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ln_mod_fwd(const void* x, const void* s0, const void* b0, const void* s1,
                          const void* b1, void* v0, void* v1, void* mean, void* rstd,
                          int64_t rows, int L, int C, int64_t mod_stride, int nviews, float eps,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || L <= 0 || C <= 0 || (nviews != 1 && nviews != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case kFloat32:
      return ln_fwd_typed<float>(x, s0, b0, s1, b1, v0, v1, mean, rstd, rows, L, C, mod_stride,
                                 nviews, eps, s);
    case kBFloat16:
      return ln_fwd_typed<__nv_bfloat16>(x, s0, b0, s1, b1, v0, v1, mean, rstd, rows, L, C,
                                         mod_stride, nviews, eps, s);
    case kFloat16:
      return ln_fwd_typed<__half>(x, s0, b0, s1, b1, v0, v1, mean, rstd, rows, L, C, mod_stride,
                                  nviews, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ln_mod_bwd(const void* x, const void* s0, const void* s1, const void* mean,
                          const void* rstd, const void* g0, const void* g1, void* dx,
                          void* partials, int B, int L, int C, int64_t mod_stride, int nviews,
                          int rows_per_block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || C <= 0 || rows_per_block <= 0 || (nviews != 1 && nviews != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case kFloat32:
      return ln_bwd_typed<float>(x, s0, s1, mean, rstd, g0, g1, dx, partials, B, L, C,
                                 mod_stride, nviews, rows_per_block, s);
    case kBFloat16:
      return ln_bwd_typed<__nv_bfloat16>(x, s0, s1, mean, rstd, g0, g1, dx, partials, B, L, C,
                                         mod_stride, nviews, rows_per_block, s);
    case kFloat16:
      return ln_bwd_typed<__half>(x, s0, s1, mean, rstd, g0, g1, dx, partials, B, L, C,
                                  mod_stride, nviews, rows_per_block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gate_res_fwd(const void* x, const void* gate, const void* h, void* out,
                            int64_t rows, int L, int C, int64_t gate_stride, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || L <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kFloat32: return gate_fwd_typed<float>(x, gate, h, out, rows, L, C, gate_stride, s);
    case kBFloat16:
      return gate_fwd_typed<__nv_bfloat16>(x, gate, h, out, rows, L, C, gate_stride, s);
    case kFloat16: return gate_fwd_typed<__half>(x, gate, h, out, rows, L, C, gate_stride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gate_res_bwd(const void* gate, const void* h, const void* dout, void* dh,
                            void* partials, int B, int L, int C, int64_t gate_stride,
                            int rows_per_block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || C <= 0 || rows_per_block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case kFloat32:
      return gate_bwd_typed<float>(gate, h, dout, dh, partials, B, L, C, gate_stride,
                                   rows_per_block, s);
    case kBFloat16:
      return gate_bwd_typed<__nv_bfloat16>(gate, h, dout, dh, partials, B, L, C, gate_stride,
                                           rows_per_block, s);
    case kFloat16:
      return gate_bwd_typed<__half>(gate, h, dout, dh, partials, B, L, C, gate_stride,
                                    rows_per_block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
