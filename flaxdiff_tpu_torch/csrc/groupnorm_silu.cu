// Fused GroupNorm + SiLU over channels-last [B, HW, C] activations: the
// forward in two kernels and the backward in two, each pair with a small
// finalize between them (done by the wrapper, in torch).
//
// Replaces the TPU kernels `_gn_stats_kernel` (flaxdiff_tpu/ops/fused_norm.py:58,
// launched at :285), `_gn_norm_kernel` (:85, launched at :314),
// `_gn_bwd_stats_kernel` (:112, launched at :187) and `_gn_bwd_dx_kernel`
// (:149, launched at :220).
//
// Bound on the H100: bytes. The forward must read x once for the statistics
// and once more to normalize, and write the output once; the backward reads
// x and the cotangent for its statistics, again for dx, and writes dx; the
// arithmetic per element is a few flops to a few tens. The design keeps every load coalesced along C
// (contiguous in channels-last) with 16-byte vectors, and splits HW into
// blocks so that B x nblk blocks fill the 132 SMs (B x G = 16 blocks, one per
// group, would leave most of the card idle).
//
// Pass 1 (gn_stats): grid (nblk, B). Each block owns `rows_per_block` rows of
// one sample and writes, per group, the sum and the second moment shifted
// around the block's own group mean, as fused_norm.py:74-81 does. The wrapper
// merges the blocks with the Welford/Chan rule (fused_norm.py:295-311), so a
// large mean never cancels against E[x^2]. Its bound is bytes (one read of
// x), so it reads x once: few long blocks (about two a SM, as the backward
// statistics), one channel vector a thread, sums shifted by each channel's
// value in the block's first row, from which the block's mean-centred
// second moment follows exactly; the channel sums run in the backward
// statistics' fixed order, so the partials are the same from run to run.
//
// Pass 2 (gn_norm): silu((x - mean) * rstd * scale + bias) in f32, stored in
// the input dtype, in the reference's order of operations. Its bound is
// bytes, so the loop holds nothing but the 16-byte loads, the math and the
// 16-byte stores: grid (row blocks, B, channel slices of up to 256 vectors),
// one wave of as many blocks as the card holds at once, each block walking
// its sample's rows with a stride of the whole grid. A thread owns one
// channel vector for every row it visits, so it loads its VEC channels'
// mean, rstd, scale and bias into registers once, before the loop (walking
// the groups channel by channel: a vector may straddle two), and keeps 4
// rows' loads in flight. 16-bit outputs take the SiLU's exp and reciprocal
// from the approximate hardware units, whose error is far below one output
// rounding; f32 keeps expf and an IEEE divide.
//
// Backward pass 1 (gn_bwd_stats): from the forward's saved [B, G] mean and
// rstd, each block recomputes x-hat and dy (the SiLU derivative included)
// for its rows and writes the channel sums of dy and dy * x-hat,
// [B, nblk, 2, C] (dbias and dscale after the wrapper sums the blocks), and
// their group sums weighted by scale, [B, nblk, 2, G], which are the group
// sums of dxhat = dy * scale and dxhat * x-hat. Its blocks are few and long
// (fused_norm.py's rows_per_block: about two a SM), so each thread sums
// tens of rows with its channels' parameters in registers before the
// reduction, which runs in a fixed order (a warp shuffle tree, one
// shared-memory pass, one warp a group): the sums are the same from run to
// run. Backward pass 2 (gn_bwd_dx): elementwise,
// dx = rstd (dxhat - mean(dxhat) - x-hat mean(dxhat x-hat)) with the group
// means the wrapper finalizes, in gn_norm's shape (one wave of blocks, a
// channel vector's six parameters in registers, 2 rows in flight). Both
// passes recompute through one device function, gn_bwd_dy, as the TPU
// kernels share `_bwd_dy` (:97-109), and take the SiLU's sigmoid as the
// forward does (approximate units for 16-bit types, IEEE for f32).
#include <algorithm>
#include <type_traits>

#include "common.cuh"

// Threads of a statistics block (gn_stats, gn_bwd_stats).
constexpr int STATS_THREADS = 256;
// rows in flight per thread in gn_stats, which loads x alone
constexpr int STATS_UNROLL = 4;

// The statistics kernels' split of a block: thread t owns channel vector
// slice + t % vpb of each slice of vpb = min(C / VEC, 256) vectors (one slice
// unless C is wide) and rows t / vpb + k R, R = 256 / vpb. The lanes of a
// warp that share a channel vector are reduced by a shuffle tree when vpb is
// a power of two below 32; then `nparts` partial rows a channel (the warps,
// or the block's row offsets) go through shared memory.
struct StatsSplit {
  int nvec, vpb, rows_per_iter, nparts, width;
  bool tree;
  __host__ __device__ StatsSplit(int c, int vec) {
    nvec = c / vec;
    vpb = nvec < STATS_THREADS ? nvec : STATS_THREADS;
    rows_per_iter = STATS_THREADS / vpb;
    tree = vpb < 32 && (vpb & (vpb - 1)) == 0;
    nparts = tree ? STATS_THREADS / 32 : rows_per_iter;
    width = vpb * vec;
  }
  // floats of shared memory: the partial rows of two sums, and both sums
  // for every channel
  __host__ __device__ int smem_floats(int c) const { return 2 * nparts * width + 2 * c; }
};

// Two per-thread partial sums of one slice's channel vector (a0, a1: its VEC
// channels; `active` if the thread summed any rows of a channel it owns)
// into the block's channel sums csum[ch] and csum[c + ch], in a fixed order
// (a shuffle tree, one shared-memory pass a channel): the sums do not depend
// on scheduling, so they are the same from run to run.
template <int VEC>
__device__ __forceinline__ void slice_channel_sums(float (&a0)[VEC], float (&a1)[VEC],
                                                   bool active, const StatsSplit& sp, int slice,
                                                   int c, float* part, float* csum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int p = active ? tid / sp.vpb : -1;  // this thread's partial row, or -1 for none
  if (sp.tree) {
    // lanes l and l ^ vpb, l ^ 2 vpb, ... share a channel vector
    for (int off = sp.vpb; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        a0[k] += __shfl_xor_sync(0xffffffffu, a0[k], off);
        a1[k] += __shfl_xor_sync(0xffffffffu, a1[k], off);
      }
    }
    p = lane < sp.vpb ? warp : -1;
  }
  if (p >= 0) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      part[p * sp.width + (tid % sp.vpb) * VEC + k] = a0[k];
      part[(sp.nparts + p) * sp.width + (tid % sp.vpb) * VEC + k] = a1[k];
    }
  }
  __syncthreads();
  const int nch = min(sp.vpb, sp.nvec - slice) * VEC;
  for (int i = tid; i < 2 * nch; i += STATS_THREADS) {
    const int q = i >= nch, col = i - q * nch;
    const float* src = part + q * sp.nparts * sp.width + col;
    float sum = 0.f;
    for (int j = 0; j < sp.nparts; ++j) sum += src[j * sp.width];
    csum[q * c + slice * VEC + col] = sum;
  }
  __syncthreads();
}

// Forward statistics. Grid (nblk, B): block blk owns rows
// [blk * rows_per_block, ...) of sample blockIdx.y (fused_norm.py's
// rows_per_block: few, long blocks, about two a SM) over every channel, split
// as StatsSplit says. x is read once. Each channel's values are summed
// shifted by that channel's value in the block's first row, k_c (a thread
// loads its vector's shifts before the loop): S1 = sum(x - k_c) and
// S2 = sum((x - k_c)^2), a subtraction, an add and an FMA an element, with
// STATS_UNROLL rows' loads in flight. The block's channel sums follow in a
// fixed order (slice_channel_sums), then one warp a group writes, over the
// block's n rows and the group's channels,
//   gsum = sum_c (S1_c + n k_c)                  (mean m = gsum / (n cg))
//   M2   = sum_c (S2_c + (k_c - m) (2 S1_c + n (k_c - m)))
// which is sum((x - m)^2) expanded around the shifts: the second moment
// around the block's own group mean, as the TPU kernel's second pass
// computes it, with no second read. The shift is a value of the channel, so
// a large mean does not cancel in S2.
template <typename T, int VEC>
__global__ void __launch_bounds__(STATS_THREADS, 2)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int hw, int c, int groups,
                int rows_per_block) {
  extern __shared__ float smem[];
  const StatsSplit sp(c, VEC);
  float* part = smem;                             // [2][nparts][width]
  float* csum = part + 2 * sp.nparts * sp.width;  // [2][c]: S1 and S2 of each channel

  const int b = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_off = tid / sp.vpb;
  const int row_begin = blk * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, hw);
  const T* xs = x + static_cast<int64_t>(b) * hw * c;  // this sample
  const T* first = xs + static_cast<int64_t>(row_begin) * c;
  for (int slice = 0; slice < sp.nvec; slice += sp.vpb) {
    const int cv = slice + tid % sp.vpb;
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) s1[k] = s2[k] = 0.f;
    const bool active = r_off < sp.rows_per_iter && cv < sp.nvec;
    if (active) {
      float shift[VEC];
      const Vec<T, VEC> kv = load_vec<T, VEC>(first + cv * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) shift[k] = to_f32(kv.v[k]);
      const int64_t stride = static_cast<int64_t>(sp.rows_per_iter) * c;
      int r = row_begin + r_off;
      const T* xp = xs + static_cast<int64_t>(r) * c + cv * VEC;
      for (; r < row_end; r += STATS_UNROLL * sp.rows_per_iter, xp += STATS_UNROLL * stride) {
        Vec<T, VEC> v[STATS_UNROLL];
#pragma unroll
        for (int u = 0; u < STATS_UNROLL; ++u)
          if (r + u * sp.rows_per_iter < row_end) v[u] = load_vec<T, VEC>(xp + u * stride);
#pragma unroll
        for (int u = 0; u < STATS_UNROLL; ++u) {
          if (r + u * sp.rows_per_iter >= row_end) break;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float d = to_f32(v[u].v[k]) - shift[k];
            s1[k] += d;
            s2[k] = fmaf(d, d, s2[k]);
          }
        }
      }
    }
    slice_channel_sums<VEC>(s1, s2, active, sp, slice, c, part, csum);
  }

  const int cg = c / groups;
  const float n = static_cast<float>(row_end - row_begin);
  float* out = partial + (static_cast<int64_t>(b) * gridDim.x + blk) * 2 * groups;
  for (int grp = warp; grp < groups; grp += STATS_THREADS / 32) {
    float gsum = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const int ch = grp * cg + j;
      gsum += fmaf(n, to_f32(first[ch]), csum[ch]);
    }
    for (int off = 16; off > 0; off >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    const float m = gsum / (n * static_cast<float>(cg));
    float m2 = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const int ch = grp * cg + j;
      const float d = to_f32(first[ch]) - m;
      m2 += csum[c + ch] + d * fmaf(n, d, 2.0f * csum[ch]);
    }
    for (int off = 16; off > 0; off >>= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    if (lane == 0) {
      out[grp] = gsum;
      out[groups + grp] = m2;
    }
  }
}

constexpr int NORM_THREADS = 256;
constexpr int NORM_UNROLL = 4;  // rows in flight per thread

// The SiLU's sigmoid. 16-bit types take the exp and the reciprocal from the
// approximate hardware units, whose error is far below one 16-bit rounding;
// f32 keeps expf and an IEEE divide. The forward and both backward kernels
// share it.
template <typename T>
__device__ __forceinline__ float sigmoid(float y) {
  if constexpr (std::is_same<T, float>::value) return 1.0f / (1.0f + expf(-y));
  else return __fdividef(1.0f, 1.0f + __expf(-y));
}

template <typename T>
__device__ __forceinline__ float silu(float y) {
  return y * sigmoid<T>(y);
}

// The group of each of the VEC channels from ch0 on, found by walking the
// channels (a vector may straddle two groups, as at C 48 with 4 groups):
// one division per thread, none per channel.
template <int VEC>
__device__ __forceinline__ void channel_groups(int ch0, int cg, int (&grp)[VEC]) {
  int g = ch0 / cg, next = (g + 1) * cg;  // next: the next group's first channel
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (ch0 + k == next) {
      ++g;
      next += cg;
    }
    grp[k] = g;
  }
}

// The saved statistics and the affine of channel vector cv of sample b, per
// channel, into registers.
template <int VEC>
__device__ __forceinline__ void channel_params(int b, int cv, int c, int groups,
                                               const float* __restrict__ mean,
                                               const float* __restrict__ rstd,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias, float (&m)[VEC],
                                               float (&rs)[VEC], float (&sc)[VEC],
                                               float (&bi)[VEC], int (&grp)[VEC]) {
  channel_groups<VEC>(cv * VEC, c / groups, grp);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    m[k] = mean[b * groups + grp[k]];
    rs[k] = rstd[b * groups + grp[k]];
    sc[k] = scale[cv * VEC + k];
    bi[k] = bias[cv * VEC + k];
  }
}

// Thread t of a block owns channel vector blockIdx.z * vpb + t % vpb of
// sample blockIdx.y, and rows blockIdx.x * R + t / vpb + k * gridDim.x * R,
// R = blockDim.x / vpb rows a block step.
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(NORM_THREADS)
gn_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int hw, int c, int groups,
               int vpb) {
  const int cv = blockIdx.z * vpb + threadIdx.x % vpb;
  if (cv >= c / VEC) return;
  const int b = blockIdx.y;
  float m[VEC], rs[VEC], sc[VEC], bi[VEC];
  int grp[VEC];
  channel_params<VEC>(b, cv, c, groups, mean, rstd, scale, bias, m, rs, sc, bi, grp);
  const int rows_per_iter = blockDim.x / vpb;
  const int step = gridDim.x * rows_per_iter;  // rows between a thread's consecutive rows
  const int64_t stride = static_cast<int64_t>(step) * c;
  int r = blockIdx.x * rows_per_iter + threadIdx.x / vpb;
  const int64_t at = (static_cast<int64_t>(b) * hw + r) * c + cv * VEC;
  const T* xp = x + at;
  T* op = out + at;
  for (; r < hw; r += NORM_UNROLL * step, xp += NORM_UNROLL * stride, op += NORM_UNROLL * stride) {
    Vec<T, VEC> v[NORM_UNROLL];
#pragma unroll
    for (int u = 0; u < NORM_UNROLL; ++u)
      if (r + u * step < hw) v[u] = load_vec<T, VEC>(xp + u * stride);
#pragma unroll
    for (int u = 0; u < NORM_UNROLL; ++u) {
      if (r + u * step >= hw) break;
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float y = (to_f32(v[u].v[k]) - m[k]) * rs[k];
        y = y * sc[k] + bi[k];
        if (SILU) y = silu<T>(y);
        o.v[k] = from_f32<T>(y);
      }
      store_vec<T, VEC>(op + u * stride, o);
    }
  }
}

// x-hat and dy of one element from the saved statistics: the one recompute
// both backward kernels share, so they cannot disagree.
template <typename T, bool SILU>
__device__ __forceinline__ void gn_bwd_dy(float x, float g, float mean, float rstd, float scale,
                                          float bias, float& xhat, float& dy) {
  xhat = (x - mean) * rstd;
  dy = g;
  if (SILU) {
    const float y = xhat * scale + bias;
    const float sig = sigmoid<T>(y);
    dy = g * sig * (1.0f + y * (1.0f - sig));
  }
}

// rows in flight per thread in the backward kernels, which load x and the
// cotangent: 2 keeps gn_bwd_dx under 128 registers (two blocks a SM) and
// neither kernel spills
constexpr int BWD_UNROLL = 2;

// Backward statistics. Grid (nblk, B): block blk sums rows
// [blk * rows_per_block, ...) of sample blockIdx.y over every channel, so
// its group sums need no other block, split as StatsSplit says: tens of
// rows a thread with their parameters in registers before any reduction.
// The sums then run in a fixed order (slice_channel_sums, then one warp per
// group over its channels, weighted by scale).
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(STATS_THREADS, 2)
gn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    float* __restrict__ gsums, float* __restrict__ csums, int hw, int c,
                    int groups, int rows_per_block) {
  extern __shared__ float smem[];
  const StatsSplit sp(c, VEC);
  const int rows_per_iter = sp.rows_per_iter;
  float* part = smem;                             // [2][nparts][width]
  float* csum = part + 2 * sp.nparts * sp.width;  // [2][c]: the block's channel sums

  const int b = blockIdx.y, blk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r_off = tid / sp.vpb;
  const int row_end = min((blk + 1) * rows_per_block, hw);
  for (int slice = 0; slice < sp.nvec; slice += sp.vpb) {
    const int cv = slice + tid % sp.vpb;
    float a_dy[VEC], a_dyx[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a_dy[k] = a_dyx[k] = 0.f;
    const bool active = r_off < rows_per_iter && cv < sp.nvec;
    if (active) {
      float m[VEC], rs[VEC], sc[VEC], bi[VEC];
      int grp[VEC];
      channel_params<VEC>(b, cv, c, groups, mean, rstd, scale, bias, m, rs, sc, bi, grp);
      int r = blk * rows_per_block + r_off;
      const int64_t stride = static_cast<int64_t>(rows_per_iter) * c;
      const int64_t at = (static_cast<int64_t>(b) * hw + r) * c + cv * VEC;
      const T* xp = x + at;
      const T* gp = g + at;
      for (; r < row_end;
           r += BWD_UNROLL * rows_per_iter, xp += BWD_UNROLL * stride, gp += BWD_UNROLL * stride) {
        Vec<T, VEC> xv[BWD_UNROLL], gv[BWD_UNROLL];
#pragma unroll
        for (int u = 0; u < BWD_UNROLL; ++u)
          if (r + u * rows_per_iter < row_end) {
            xv[u] = load_vec<T, VEC>(xp + u * stride);
            gv[u] = load_vec<T, VEC>(gp + u * stride);
          }
#pragma unroll
        for (int u = 0; u < BWD_UNROLL; ++u) {
          if (r + u * rows_per_iter >= row_end) break;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            float xhat, dy;
            gn_bwd_dy<T, SILU>(to_f32(xv[u].v[k]), to_f32(gv[u].v[k]), m[k], rs[k], sc[k],
                               bi[k], xhat, dy);
            a_dy[k] += dy;
            a_dyx[k] += dy * xhat;
          }
        }
      }
    }
    slice_channel_sums<VEC>(a_dy, a_dyx, active, sp, slice, c, part, csum);
  }

  const int64_t out_at = static_cast<int64_t>(b) * gridDim.x + blk;
  float* cs = csums + out_at * 2 * c;
  for (int i = tid; i < 2 * c; i += STATS_THREADS) cs[i] = csum[i];
  const int cg = c / groups;
  float* gs = gsums + out_at * 2 * groups;
  for (int grp = warp; grp < groups; grp += STATS_THREADS / 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const int ch = grp * cg + j;
      s1 += scale[ch] * csum[ch];
      s2 += scale[ch] * csum[c + ch];
    }
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      gs[grp] = s1;
      gs[groups + grp] = s2;
    }
  }
}

// dx = rstd (dy scale - s1 - x-hat s2), s1 and s2 the group means of dxhat
// and dxhat x-hat. The shape of gn_norm_kernel: a thread owns one channel
// vector, loads its six parameters a channel into registers once, and
// strides over its sample's rows with 2 rows' loads (x and the cotangent)
// in flight, two blocks a SM.
template <typename T, int VEC, bool SILU>
__global__ void __launch_bounds__(NORM_THREADS, 2)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ s,
                 T* __restrict__ dx, int hw, int c, int groups, int vpb) {
  const int cv = blockIdx.z * vpb + threadIdx.x % vpb;
  if (cv >= c / VEC) return;
  const int b = blockIdx.y;
  float m[VEC], rs[VEC], sc[VEC], bi[VEC], s1[VEC], s2[VEC];
  int grp[VEC];
  channel_params<VEC>(b, cv, c, groups, mean, rstd, scale, bias, m, rs, sc, bi, grp);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s1[k] = s[2 * b * groups + grp[k]];
    s2[k] = s[(2 * b + 1) * groups + grp[k]];
  }
  const int rows_per_iter = blockDim.x / vpb;
  const int step = gridDim.x * rows_per_iter;
  const int64_t stride = static_cast<int64_t>(step) * c;
  int r = blockIdx.x * rows_per_iter + threadIdx.x / vpb;
  const int64_t at = (static_cast<int64_t>(b) * hw + r) * c + cv * VEC;
  const T* xp = x + at;
  const T* gp = g + at;
  T* op = dx + at;
  for (; r < hw; r += BWD_UNROLL * step, xp += BWD_UNROLL * stride,
                 gp += BWD_UNROLL * stride, op += BWD_UNROLL * stride) {
    Vec<T, VEC> xv[BWD_UNROLL], gv[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u)
      if (r + u * step < hw) {
        xv[u] = load_vec<T, VEC>(xp + u * stride);
        gv[u] = load_vec<T, VEC>(gp + u * stride);
      }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (r + u * step >= hw) break;
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float xhat, dy;
        gn_bwd_dy<T, SILU>(to_f32(xv[u].v[k]), to_f32(gv[u].v[k]), m[k], rs[k], sc[k], bi[k],
                           xhat, dy);
        o.v[k] = from_f32<T>(rs[k] * (dy * sc[k] - s1[k] - xhat * s2[k]));
      }
      store_vec<T, VEC>(op + u * stride, o);
    }
  }
}

template <typename T, int VEC>
static int launch_stats(const void* x, float* partial, int batch, int hw, int c, int groups,
                        int rows_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * StatsSplit(c, VEC).smem_floats(c);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (hw + rows_per_block - 1) / rows_per_block;
  gn_stats_kernel<T, VEC><<<dim3(nblk, batch), STATS_THREADS, smem, stream>>>(
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

// Blocks of NORM_THREADS threads that the card holds at once for `kernel`
// (from the occupancy calculator; each launcher reads it once).
template <typename Kernel>
static int64_t resident_blocks(Kernel kernel) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, NORM_THREADS, 0) != cudaSuccess ||
      n < 1)
    n = 1;
  return static_cast<int64_t>(n) * sm_count();
}

// One wave over [batch, hw, nvec channel vectors] for the strided kernels
// (gn_norm, gn_bwd_dx): channel vectors per block row `vpb`, up to
// NORM_THREADS, the rest in further slices (gridDim.z); `resident` blocks
// in all, no more than the rows need.
static dim3 wave_grid(int64_t resident, int batch, int hw, int nvec, int& vpb, int& threads) {
  vpb = nvec < NORM_THREADS ? nvec : NORM_THREADS;
  const int rows_per_iter = NORM_THREADS / vpb;
  threads = rows_per_iter * vpb;
  const int slices = (nvec + vpb - 1) / vpb;
  const int64_t row_blocks = (hw + rows_per_iter - 1) / rows_per_iter;
  const int64_t per_sample = resident / (static_cast<int64_t>(batch) * slices);
  return dim3(static_cast<unsigned>(per_sample < 1 ? 1 : std::min(per_sample, row_blocks)), batch,
              slices);
}

template <typename T, int VEC, bool SILU>
static int launch_norm(const void* x, const float* mean, const float* rstd, const float* scale,
                       const float* bias, void* out, int batch, int hw, int c, int groups,
                       cudaStream_t stream) {
  static const int64_t resident = resident_blocks(gn_norm_kernel<T, VEC, SILU>);
  int vpb, threads;
  const dim3 grid = wave_grid(resident, batch, hw, c / VEC, vpb, threads);
  gn_norm_kernel<T, VEC, SILU><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, scale, bias, static_cast<T*>(out), hw, c, groups,
      vpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
static int launch_norm(const void* x, const float* mean, const float* rstd, const float* scale,
                       const float* bias, void* out, int batch, int hw, int c, int groups,
                       int apply_silu, cudaStream_t stream) {
  if (apply_silu)
    return launch_norm<T, VEC, true>(x, mean, rstd, scale, bias, out, batch, hw, c, groups,
                                     stream);
  return launch_norm<T, VEC, false>(x, mean, rstd, scale, bias, out, batch, hw, c, groups, stream);
}

template <typename T>
static int norm_dispatch(const void* x, const float* mean, const float* rstd, const float* scale,
                         const float* bias, void* out, int batch, int hw, int c, int groups,
                         int apply_silu, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  if (c % V == 0 && aligned16(x) && aligned16(out))
    return launch_norm<T, V>(x, mean, rstd, scale, bias, out, batch, hw, c, groups, apply_silu,
                             stream);
  return launch_norm<T, 1>(x, mean, rstd, scale, bias, out, batch, hw, c, groups, apply_silu,
                           stream);
}

template <typename T, int VEC, bool SILU>
static int launch_bwd_stats(const void* x, const void* g, const float* mean, const float* rstd,
                            const float* scale, const float* bias, float* gsums, float* csums,
                            int batch, int hw, int c, int groups, int rows_per_block,
                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * StatsSplit(c, VEC).smem_floats(c);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (hw + rows_per_block - 1) / rows_per_block;
  gn_bwd_stats_kernel<T, VEC, SILU><<<dim3(nblk, batch), STATS_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd, scale, bias, gsums, csums,
      hw, c, groups, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int bwd_stats_dispatch(const void* x, const void* g, const float* mean, const float* rstd,
                              const float* scale, const float* bias, float* gsums, float* csums,
                              int batch, int hw, int c, int groups, int rows_per_block,
                              int apply_silu, cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const bool wide = c % V == 0 && aligned16(x) && aligned16(g);
  if (wide && apply_silu)
    return launch_bwd_stats<T, V, true>(x, g, mean, rstd, scale, bias, gsums, csums, batch, hw,
                                        c, groups, rows_per_block, stream);
  if (wide)
    return launch_bwd_stats<T, V, false>(x, g, mean, rstd, scale, bias, gsums, csums, batch, hw,
                                         c, groups, rows_per_block, stream);
  if (apply_silu)
    return launch_bwd_stats<T, 1, true>(x, g, mean, rstd, scale, bias, gsums, csums, batch, hw,
                                        c, groups, rows_per_block, stream);
  return launch_bwd_stats<T, 1, false>(x, g, mean, rstd, scale, bias, gsums, csums, batch, hw, c,
                                       groups, rows_per_block, stream);
}

template <typename T, int VEC, bool SILU>
static int launch_bwd_dx(const void* x, const void* g, const float* mean, const float* rstd,
                         const float* scale, const float* bias, const float* s, void* dx,
                         int batch, int hw, int c, int groups, cudaStream_t stream) {
  static const int64_t resident = resident_blocks(gn_bwd_dx_kernel<T, VEC, SILU>);
  int vpb, threads;
  const dim3 grid = wave_grid(resident, batch, hw, c / VEC, vpb, threads);
  gn_bwd_dx_kernel<T, VEC, SILU><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd, scale, bias, s,
      static_cast<T*>(dx), hw, c, groups, vpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int bwd_dx_dispatch(const void* x, const void* g, const float* mean, const float* rstd,
                           const float* scale, const float* bias, const float* s, void* dx,
                           int batch, int hw, int c, int groups, int apply_silu,
                           cudaStream_t stream) {
  constexpr int V = vec16<T>();
  const bool wide = c % V == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  if (wide && apply_silu)
    return launch_bwd_dx<T, V, true>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c, groups,
                                     stream);
  if (wide)
    return launch_bwd_dx<T, V, false>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c, groups,
                                      stream);
  if (apply_silu)
    return launch_bwd_dx<T, 1, true>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c, groups,
                                     stream);
  return launch_bwd_dx<T, 1, false>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c, groups,
                                    stream);
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

extern "C" int gn_bwd_stats(const void* x, const void* g, const float* mean, const float* rstd,
                            const float* scale, const float* bias, float* gsums, float* csums,
                            int batch, int hw, int c, int groups, int rows_per_block,
                            int apply_silu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return bwd_stats_dispatch<float>(x, g, mean, rstd, scale, bias, gsums, csums, batch, hw, c,
                                       groups, rows_per_block, apply_silu, s);
    case kBFloat16:
      return bwd_stats_dispatch<__nv_bfloat16>(x, g, mean, rstd, scale, bias, gsums, csums, batch,
                                               hw, c, groups, rows_per_block, apply_silu, s);
    case kFloat16:
      return bwd_stats_dispatch<__half>(x, g, mean, rstd, scale, bias, gsums, csums, batch, hw, c,
                                        groups, rows_per_block, apply_silu, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gn_bwd_dx(const void* x, const void* g, const float* mean, const float* rstd,
                         const float* scale, const float* bias, const float* s, void* dx,
                         int batch, int hw, int c, int groups, int apply_silu, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return bwd_dx_dispatch<float>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c, groups,
                                    apply_silu, st);
    case kBFloat16:
      return bwd_dx_dispatch<__nv_bfloat16>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c,
                                            groups, apply_silu, st);
    case kFloat16:
      return bwd_dx_dispatch<__half>(x, g, mean, rstd, scale, bias, s, dx, batch, hw, c, groups,
                                     apply_silu, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
