// The Hopper main loop shared by the batch-invariant GEMM (bi_gemm.cu) and
// the implicit-GEMM convolution (bi_conv.cu) in bf16 and f16:
//
//   out[z][m][n] = sum_k A_z(m, k) * W[n][k] + bias[n]
//
// The batch-invariance contract (fault C6) is bi_mma.cuh's: each output is
// one f32 accumulator over k in one fixed order, K tiles of BK = 64 in
// ascending order and inside a tile four wgmma k16 steps in order; the bias
// is added once to the finished sum and the result rounded once. The block
// tile (128 x BN) is a template argument that the caller's route picks from
// the weight's shape alone (ops/batch_invariant.py: gemm_route, conv_route),
// never from the row count or the batch; there is no split-K, no stream-K,
// no atomic and no persistent scheduler. TMA zero-fills what lies past M, N
// and K (and a convolution's padding), so padding adds exact zeros.
//
// Design, for the bound (operations at the served models' large shapes,
// the output's bytes at the GEGLU input's):
//   * two consumer warpgroups of 64 rows each (BM = 128), no producer
//     warp: thread 0 issues the TMA loads of A's and W's 64-column
//     tiles (128-byte rows, 128-byte swizzle) into a ring of STAGES stages,
//     each on one mbarrier, STAGES tiles ahead of the math;
//   * a k tile is four wgmma (m64 nBN k16, both operands K-major in shared
//     memory, bi_mma.cuh's x W^T), then every warp syncs and thread 0 refills
//     the stage just read; two blocks share an SM (at most 96 KB of ring each
//     and 128 registers a thread), so one block's loads and epilogue run
//     under the other's math;
//   * the epilogue adds the bias in f32, rounds once, writes each
//     warpgroup's 64 x BN tile as 64-column chunks into its own (consumed)
//     rows of the ring's A tiles in the swizzled layout, and stores each
//     chunk with one TMA store, which skips what lies past M and N: whole
//     16-byte rows, no element-wise stores.
#pragma once

#include <atomic>

#include "hopper.cuh"

// The variants a batch-invariant call can take, as ops/batch_invariant.py's
// ROUTES names them: the caller picks one from the operands' shapes and
// dtype, and a launcher that does not take the code returns an error.
enum BiRoute : int {
  kRouteMma = 0,          // mma.sync 128 x 128 (bi_mma.cuh), bf16 / f16
  kRouteFma = 1,          // FMA 64 x 64 (bi_mma.cuh), f32
  kRouteNarrow = 2,       // the f32 convolution to at most 8 channels (bi_conv.cu)
  kRouteWgmma128x128 = 3, // this file's loop, BM x BN = 128 x 128
  kRouteWgmma128x64 = 4,  // 128 x 64
};

namespace biw {

constexpr int BK = 64;  // k values per tile: one 128-byte swizzled row

template <int BN_>
struct Cfg {
  static constexpr int BM = 128, BN = BN_;
  static constexpr int THREADS = 256;  // two consumer warpgroups, 64 rows each
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // as many stages as fit 96 KB, at most 4: two blocks an SM
  static constexpr int RING = 96 * 1024 / STAGE_BYTES;
  static constexpr int STAGES = RING < 4 ? RING : 4;
  static constexpr int OFF_BAR = STAGES * STAGE_BYTES;
  static constexpr int BYTES = OFF_BAR + 8 * STAGES + 1024;  // + base alignment
  static_assert(BN == 64 || BN == 128, "BN of 64 or 128");
  static_assert(STAGES >= BN / 64, "the epilogue stages BN / 64 chunks in the ring's A tiles");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "tiles of whole swizzle atoms");
};

// The ring's stage s: A's BM x 64 tile, then W's BN x 64 tile.
template <class C>
__device__ __forceinline__ unsigned char* stage(unsigned char* sm, int s) {
  return sm + s * C::STAGE_BYTES;
}

// The block's K loop. issue(u, stage_base, bar) loads k tile u (A at the
// stage's base, W after C::A_BYTES) and reports C::STAGE_BYTES to bar;
// acc is this thread's part of its warpgroup's 64 x BN accumulator.
template <typename T, class C, class Issue>
__device__ __forceinline__ void mainloop(unsigned char* sm, int tiles, const Issue& issue,
                                         float (&acc)[C::BN / 2]) {
  using namespace hopper;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < C::STAGES && u < tiles; ++u) issue(u, stage<C>(sm, u), &full[u]);
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
  for (int u = 0; u < tiles; ++u) {
    const int st = u % C::STAGES;
    unsigned char* sA = stage<C>(sm, st);
    const unsigned char* sB = sA + C::A_BYTES;
    mbar_wait(&full[st], (u / C::STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss<C::BN, T>(acc, desc_kmajor<BK>(sA, C::BM, 64 * wg, kk),
                         desc_kmajor<BK>(sB, C::BN, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done reading stage st
    if (tid == 0 && u + C::STAGES < tiles) issue(u + C::STAGES, sA, &full[st]);
  }
}

// The epilogue's first half: acc + bias in f32, rounded once to T, into the
// warpgroup's 64 rows of the ring's A tiles, chunk c (columns 64 c ..) in
// stage c, under the 128-byte swizzle TMA stores read. Returns the chunk
// base of chunk 0 (chunk c is C::STAGE_BYTES further); the warpgroup's
// thread 0 then stores each chunk (store_chunks).
template <typename T, class C>
__device__ __forceinline__ unsigned char* stage_out(unsigned char* sm, const float (&acc)[C::BN / 2],
                                                    const T* __restrict__ bias, int n0, int n) {
  using namespace hopper;
  const int tid = threadIdx.x % 128, wg = threadIdx.x / 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  unsigned char* out = sm + wg * 64 * BK * 2;
#pragma unroll
  for (int j8 = 0; j8 < C::BN / 8; ++j8) {
    const int col = 8 * j8 + 2 * tq;
    const float b0 = bias != nullptr && n0 + col < n ? to_f32(bias[n0 + col]) : 0.f;
    const float b1 = bias != nullptr && n0 + col + 1 < n ? to_f32(bias[n0 + col + 1]) : 0.f;
    unsigned char* chunk = out + (col / 64) * C::STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t off = swizzled_offset<64>(64, 16 * warp + g + 8 * j, col % 64);
      *reinterpret_cast<uint32_t*>(chunk + off) =
          pack2<T>(acc[4 * j8 + 2 * j] + b0, acc[4 * j8 + 2 * j + 1] + b1);
    }
  }
  fence_async_smem();
  named_barrier(1 + wg, 128);
  return out;
}

// The epilogue's second half, by the warpgroup's thread 0: store(chunk
// base, c) issues chunk c's TMA store for each chunk with a column below n,
// then waits until the stores have read shared memory.
template <class C, class Store>
__device__ __forceinline__ void store_chunks(unsigned char* out, int n0, int n, const Store& store) {
  if (threadIdx.x % 128 != 0) return;
#pragma unroll
  for (int c = 0; c < C::BN / 64; ++c)
    if (n0 + 64 * c < n) store(out + c * C::STAGE_BYTES, c);
  hopper::tma_store_wait();
}

// A kernel's dynamic shared-memory limit, raised once a device: the
// launchers run on every served call, and cudaFuncSetAttribute costs host
// time on each. `done` is the calling launcher's own static, one bit a
// device (a device past 63 sets the attribute on every call).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace biw
