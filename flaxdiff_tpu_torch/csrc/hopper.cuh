// Hopper (sm_90a) machinery shared by the flash-attention kernels and the
// batch-invariant GEMM and convolution (bi_wgmma.cuh): shared-memory matrix
// descriptors and the warpgroup matrix multiply (wgmma), the mbarrier
// pipeline helpers, the tensor memory accelerator's (TMA) 2-D and 4-D tile
// load and store, and the host-side encoding of the tensor maps they read.
// Inline PTX throughout (PTX ISA 8.0: wgmma, mbarrier, cp.async.bulk.tensor).
//
// Conventions:
//   * a [B, L, H, D] operand is a 4-D tensor map with dims (D, H, L, B) and
//     its byte strides, so a q/k/v view of one [B, L, 3 H D] projection needs
//     no copy and rows past L load as zeros (L is a dimension of its own);
//   * a tile of R rows is stored as D / CW column chunks of [R x CW], CW =
//     min(D, 64) elements: 128-byte rows under the 128-byte swizzle for
//     D = 64, 128 and 256, 64-byte rows under the 64-byte swizzle for D = 32;
//     the chunk bases are 1024-byte aligned, as the swizzle atoms need;
//   * wgmma's f32 accumulator of a 64 x N tile: thread i of the warpgroup
//     (warp w = i / 32, g = (i % 32) / 4, t = i % 4) holds rows 16 w + g
//     (j = 0) and 16 w + g + 8 (j = 1), columns 8 n + 2 t + c, in register
//     4 n + 2 j + c. For 16-bit types this is also the register-A fragment
//     layout of a 64 x 16 slice: no shuffle turns scores into an operand.
#pragma once

#include <cuda.h>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared-memory base rounded up to the 1024-byte swizzle atom
// (a launch asks for 1024 bytes more than its layout).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// --- column chunks and swizzle ----------------------------------------------

// Elements of a D-wide 16-bit row in one swizzled chunk.
template <int D>
__host__ __device__ constexpr int chunk_cols() { return D < 64 ? D : 64; }

template <int D>
__host__ __device__ constexpr int chunk_row_bytes() { return 2 * chunk_cols<D>(); }

// The wgmma descriptor's layout code and the TMA swizzle for D's chunks.
template <int D>
__host__ __device__ constexpr int desc_layout() { return chunk_row_bytes<D>() == 128 ? 1 : 2; }

template <int D>
constexpr CUtensorMapSwizzle tma_swizzle() {
  return chunk_row_bytes<D>() == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// Byte offset of element (r, col) of a chunked, swizzled tile of `rows`
// rows: the 16-byte unit index is XORed with address bits 7-9 (128-byte
// swizzle) or 7-8 (64-byte swizzle), as TMA writes and wgmma reads it.
template <int D>
__device__ __forceinline__ uint32_t swizzled_offset(int rows, int r, int col) {
  constexpr int CW = chunk_cols<D>(), RB = chunk_row_bytes<D>();
  const int chunk = col / CW, c = col % CW;
  const int unit = c / 8;
  const int phase = RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return static_cast<uint32_t>(chunk * rows * RB + r * RB + ((unit ^ phase) << 4) + (c % 8) * 2);
}

// --- wgmma ---------------------------------------------------------------

// Matrix descriptor: start address, leading and stride byte offsets (16-byte
// units), swizzle layout (1: 128 B, 2: 64 B). Base offset 0: every chunk
// base is aligned to its swizzle atom.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(layout) << 62;
  return d;
}

// K-major operand (rows of a tile, K = D along the row), slice kk of 16
// columns: the start moves 32 bytes along the swizzled row; 8-row groups are
// 8 rows apart (SBO); LBO is unused while 16 columns fit one swizzle row.
// `tile` is the tile's base, `row0` its first row, `rows` its row count.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int rows, int row0, int kk) {
  constexpr int CW = chunk_cols<D>(), RB = chunk_row_bytes<D>();
  const uint32_t addr = smem_u32(tile) + (kk * 16 / CW) * rows * RB + row0 * RB + (kk * 16 % CW) * 2;
  return make_desc(addr, 16, 8 * RB, desc_layout<D>());
}

// MN-major operand (a [K rows x D] tile read as B with N contiguous), slice
// kk of 16 rows, from column col0 (a multiple of the chunk width) on: LBO
// steps between column chunks, SBO between 8-row groups.
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int rows, int kk,
                                                 int col0 = 0) {
  constexpr int CW = chunk_cols<D>(), RB = chunk_row_bytes<D>();
  const uint32_t addr = smem_u32(tile) + (col0 / CW) * rows * RB + kk * 16 * RB;
  return make_desc(addr, rows * RB, 8 * RB, desc_layout<D>());
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place: no read or write of them moves
// across this point (the compiler cannot see wgmma's asynchronous writes).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register-A fragments.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Two f32 values rounded to T and packed low-first into one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// The register-A fragment of columns 16 kk .. 16 kk + 15 of an accumulator,
// rounded to T.
template <typename T, int R>
__device__ __forceinline__ void acc_to_a(const float (&s)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
#define FLAXDIFF_WGMMA(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "  \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (std::is_same<T, __half>::value) FLAXDIFF_WGMMA("f16");
  else FLAXDIFF_WGMMA("bf16");
#undef FLAXDIFF_WGMMA
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
#define FLAXDIFF_WGMMA(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (std::is_same<T, __half>::value) FLAXDIFF_WGMMA("f16");
  else FLAXDIFF_WGMMA("bf16");
#undef FLAXDIFF_WGMMA
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory
template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
#define FLAXDIFF_WGMMA(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (std::is_same<T, __half>::value) FLAXDIFF_WGMMA("f16");
  else FLAXDIFF_WGMMA("bf16");
#undef FLAXDIFF_WGMMA
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A in registers (the 16-bit A
// fragment), B MN-major in shared memory (the transpose bit set)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
#define FLAXDIFF_WGMMA(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "  \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (std::is_same<T, __half>::value) FLAXDIFF_WGMMA("f16");
  else FLAXDIFF_WGMMA("bf16");
#undef FLAXDIFF_WGMMA
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (the 16-bit A
// fragment), B MN-major in shared memory (the transpose bit set)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
#define FLAXDIFF_WGMMA(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (std::is_same<T, __half>::value) FLAXDIFF_WGMMA("f16");
  else FLAXDIFF_WGMMA("bf16");
#undef FLAXDIFF_WGMMA
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (the 16-bit A
// fragment), B MN-major in shared memory (the transpose bit set)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
#define FLAXDIFF_WGMMA(TY)                                                       \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  if constexpr (std::is_same<T, __half>::value) FLAXDIFF_WGMMA("f16");
  else FLAXDIFF_WGMMA("bf16");
#undef FLAXDIFF_WGMMA
}

template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32<T>(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64<T>(d, da, db, scale_d);
  else wgmma_ss_n128<T>(d, da, db, scale_d);
}

template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32<T>(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64<T>(d, a, db);
  else wgmma_rs_n128<T>(d, a, db);
}

// Columns col0 .. col0 + 127 of a 64 x N accumulator (N = 2 * the register
// count) as an accumulator of its own: register 4 n + i of the N = 128 layout
// is register 4 (n + col0 / 8) + i of the wider one.
template <int R>
__device__ __forceinline__ float (&acc_cols128(float (&d)[R], int col0))[64] {
  return *reinterpret_cast<float(*)[64]>(&d[col0 / 2]);
}

// D[64 x D] += A[64 x 16] . B[16 x D] over a whole head dim: B is rows of the
// MN-major tile `tile` (`rows` rows), slice kk. One wgmma up to D = 128; at
// D = 256 two of N = 128, one on each column half (the accumulator holds the
// same 128 registers a thread as one N = 256 wgmma's, and the two reuse the
// N = 128 instruction).
template <int D, typename T>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[D / 2], const uint32_t (&a)[4],
                                              const void* tile, int rows, int kk) {
  if constexpr (D <= 128) {
    wgmma_rs<D, T>(d, a, desc_mnmajor<D>(tile, rows, kk));
  } else {
    static_assert(D == 256, "head dims 32, 64, 128 and 256");
    wgmma_rs_n128<T>(acc_cols128(d, 0), a, desc_mnmajor<D>(tile, rows, kk, 0));
    wgmma_rs_n128<T>(acc_cols128(d, 128), a, desc_mnmajor<D>(tile, rows, kk, 128));
  }
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA data.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Synchronises the `threads` threads (whole warps) that name barrier `id`;
// id 0 is __syncthreads'.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- TMA ---------------------------------------------------------------------

// Box (c0, c1, c2, c3) of a 4-D tensor map into shared memory; completion
// (its bytes) is reported to `bar`. Out-of-bounds elements load as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Box (c0, c1, c2, c3) from shared memory to the tensor; elements out of
// bounds are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Box (c0, c1) of a 2-D tensor map into shared memory, as tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Box (c0, c1) from shared memory to a 2-D tensor, as tma_store_4d.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to TMA's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Commits the issued TMA stores and waits until they have read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// TMA stores of a box of rows of a chunked, swizzled tile in shared memory:
// one box per column chunk, the chunks `rows` rows apart, starting at `tile`;
// rows past the tensor's end are skipped.
template <int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const unsigned char* tile,
                                               int rows, int h, int row0, int b) {
  constexpr int CW = chunk_cols<D>();
#pragma unroll
  for (int c = 0; c < D / CW; ++c)
    tma_store_4d(map, tile + c * rows * chunk_row_bytes<D>(), c * CW, h, row0, b);
}

// A tile of `rows` rows into shared memory: D / CW boxes on one barrier.
template <int D>
__device__ __forceinline__ void tma_load_tile(unsigned char* tile, const CUtensorMap* map,
                                              uint64_t* bar, int rows, int h, int row0, int b) {
  constexpr int CW = chunk_cols<D>();
#pragma unroll
  for (int c = 0; c < D / CW; ++c)
    tma_load_4d(tile + c * rows * chunk_row_bytes<D>(), map, bar, c * CW, h, row0, b);
}

// --- host: tensor maps ---------------------------------------------------------

// The tensor map of a [B, L, H, D] 16-bit operand with element strides
// (sb, sl, sh) (the head dim contiguous), boxes of `box_rows` rows by one
// column chunk. Returns the driver's CUresult (0 on success).
inline int encode_bhld_map(CUtensorMap* map, const void* ptr, int dtype, int batch, int len,
                           int heads, int d, int64_t sb, int64_t sl, int64_t sh, int box_rows,
                           int box_cols, CUtensorMapSwizzle swizzle) {
  const CUtensorMapDataType type =
      dtype == kFloat16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2), static_cast<cuuint64_t>(sl * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1u,
                             static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t elem_strides[4] = {1u, 1u, 1u, 1u};
  return static_cast<int>(cuTensorMapEncodeTiled(
      map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D>
inline int encode_bhld(CUtensorMap* map, const void* ptr, int dtype, int batch, int len,
                       int heads, int64_t sb, int64_t sl, int64_t sh, int box_rows) {
  return encode_bhld_map(map, ptr, dtype, batch, len, heads, D, sb, sl, sh, box_rows,
                         chunk_cols<D>(), tma_swizzle<D>());
}

// The same for the wide kernels' operands: a head dim `d` above 256 (a
// multiple of 64) known at run time, boxes of `box_rows` rows by one
// 64-column chunk under the 128-byte swizzle (D = 64's chunk layout).
inline int encode_bhld_wide(CUtensorMap* map, const void* ptr, int dtype, int batch, int len,
                            int heads, int d, int64_t sb, int64_t sl, int64_t sh, int box_rows) {
  return encode_bhld_map(map, ptr, dtype, batch, len, heads, d, sb, sl, sh, box_rows,
                         chunk_cols<64>(), tma_swizzle<64>());
}

// The tensor map of a 16-bit tensor of `rank` (2 to 4) dimensions, dims[0]
// contiguous, the byte strides of dims 1 .. rank - 1 in `strides`, boxes of
// box[0 .. rank - 1] elements. Returns cuTensorMapEncodeTiled's CUresult (0 on success).
inline int encode_tiled(CUtensorMap* map, const void* ptr, int dtype, int rank,
                        const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                        CUtensorMapSwizzle swizzle) {
  const CUtensorMapDataType type =
      dtype == kFloat16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cuuint64_t d[4], s[3];
  cuuint32_t b[4], e[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    e[i] = 1u;
    if (i + 1 < rank) s[i] = static_cast<cuuint64_t>(strides[i]);
  }
  return static_cast<int>(cuTensorMapEncodeTiled(
      map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), d, s, b, e,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Error code a launcher returns when a tensor map cannot be encoded: above
// every cudaError_t, with the driver's CUresult added.
constexpr int kTensorMapError = 100000;

}  // namespace hopper
