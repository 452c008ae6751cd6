// bf16 pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// for Hopper (sm_90a): `mma.sync.m16n8k16` with bf16 operands and f32
// accumulators, bf16 fragment loads from shared memory, the split of an f32
// operand into two bf16 parts, and the bf16 cp.async tile copy.
//
// Products of two bf16 inputs (Q K^T, dO V^T) are exact in one mma: the
// product of two bf16 values fits an f32 exactly, so only the order of the
// f32 sum differs from an f32 product. A product with an f32 operand (P V,
// P^T dO, dS K, dS^T Q) splits that operand x into hi = bf16(x) and
// lo = bf16(x - hi) and issues two mmas, lo first: |x - hi - lo| is below
// 2^-16 |x|, so the sums keep f32-like accuracy before the one rounding of
// the result to bf16.
//
// Fragment layouts of m16n8k16 .bf16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4; each 32-bit register
// holds two bf16, the lower column (or k) in the lower half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                           a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, col-major):  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, f32):        c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// So two C fragments of adjacent 8-column tiles are, element for element,
// the A fragment of their 16 columns: P and dS go from the accumulators of
// one product to the A operand of the next without shared memory.
//
// Shared tiles are row-major bf16 with a row stride of cols + 8 (cols a
// multiple of 8): every row starts on a 16-byte boundary (cp.async,
// ldmatrix), and the 32-bit fragment reads of 8 rows fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace t2p {

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int pad_ld16(int cols) { return cols + 8; }

// D rounded up to the mma's depth of 16; the extra 8 columns of a tile
// (D % 16 == 8) are zeros.
__host__ __device__ inline int round16(int d) { return (d + 15) & ~15; }

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 (nearest even), `lo` in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) ~ hi + lo, each a pair of bf16.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// The hi and lo bf16 parts of a 16 x 16 A fragment, made from the f32
// accumulator fragments of its columns 0-7 (c0) and 8-15 (c1).
struct SplitA16 {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ SplitA16 split_c_to_a(const float c0[4],
                                                 const float c1[4]) {
  SplitA16 s;
  split_bf16(c0[0], c0[1], s.hi[0], s.lo[0]);
  split_bf16(c0[2], c0[3], s.hi[1], s.lo[1]);
  split_bf16(c1[0], c1[1], s.hi[2], s.lo[2]);
  split_bf16(c1[2], c1[3], s.hi[3], s.lo[3]);
  return s;
}

// c += a * b with a split into hi and lo parts and b a bf16 fragment.
__device__ __forceinline__ void mma_split(float c[4], const SplitA16& a,
                                          const uint32_t b[2]) {
  mma_bf16(c, a.lo, b);
  mma_bf16(c, a.hi, b);
}

// A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a16(uint32_t a[4], const bf16* s, int ld,
                                         int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + g * ld + k0 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// B fragment (k x n = 16 x 8) with B[k][n] = s[(n0 + n) * ld + k0 + k]: the
// transpose of a row-major tile, as in Q K^T.
__device__ __forceinline__ void load_bt16(uint32_t b[2], const bf16* s,
                                          int ld, int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

// B fragment with B[k][n] = s[(k0 + k) * ld + n0 + n]: a row-major tile
// read as it is, as in P V. `ldmatrix .trans` gives each lane the pair
// (k = 2t, 2t + 1; n = g) of the two 8 x 8 matrices whose rows lanes 0-7
// (k0 .. k0 + 7) and 8-15 (k0 + 8 .. k0 + 15) address; every row address is
// 16-byte aligned (n0 % 8 == 0, ld % 8 == 0).
__device__ __forceinline__ void load_bn16(uint32_t b[2], const bf16* s,
                                          int ld, int n0, int k0, int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * ld + n0;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// Issues the copy of rows [r0, r0 + rows) and columns [c0, c0 + cols) of a
// row-major (., row_len) bf16 matrix into a shared tile of stride ld; rows
// at or past `limit` are filled with zeros. cols % 8 == 0 (16 bytes a
// copy). All threads of the block take part.
__device__ __forceinline__ void load_tile_async16(bf16* dst, int ld,
                                                  const bf16* src,
                                                  int row_len, int r0,
                                                  int rows, int limit, int c0,
                                                  int cols) {
  const int per_row = cols >> 3;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = (e - r * per_row) << 3;
    const bool in = r0 + r < limit;
    const bf16* g = src + (size_t)(in ? r0 + r : 0) * row_len + c0 + c;
    cp_async16(dst + r * ld + c, g, in);
  }
}

// Zeros columns [d, d + 8) of `rows` rows of a tile of stride ld: the
// padding of D up to the mma depth where D % 16 == 8 (cp.async never
// writes there, so it stays zero).
__device__ __forceinline__ void zero_pad16(bf16* s, int ld, int rows, int d) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    *reinterpret_cast<uint4*>(s + r * ld + d) = make_uint4(0u, 0u, 0u, 0u);
}

// Launch plan of a bf16 kernel: warps (16 rows each), inner tile rows T,
// column chunks (grid z) of dc columns, the instantiation and the launch
// shape. Both stages of the inner tiles are double-buffered.
struct Bf16Plan {
  int warps, t, nchunk, dc, idx;
  dim3 grid;
  size_t smem;
};

// The first plan whose shared memory fits: the most warps (at most 4, and
// no more than `rows` needs), then two blocks per SM (113 KB) before one
// (227 KB), then the largest inner tile (16, 32 or 64 rows, at most
// `tile_cap` and no more than `loop` needs). smem(warps, t) is in bytes.
template <typename Smem>
bool plan_bf16(Bf16Plan& p, int bh, int rows, int loop, int tile_cap,
               Smem smem) {
  int cap = 16;
  while (cap < tile_cap && cap < loop) cap *= 2;
  const size_t limits[2] = {113 * 1024, 227 * 1024};
  for (int warps = min(4, (rows + ROWS - 1) / ROWS); warps >= 1;
       warps /= 2)
    for (size_t limit : limits)
      for (int t = cap; t >= 16; t /= 2)
        if (smem(warps, t) <= limit) {
          p.warps = warps;
          p.t = t;
          p.smem = smem(warps, t);
          p.grid = dim3(bh, (rows + ROWS * warps - 1) / (ROWS * warps),
                        p.nchunk);
          return true;
        }
  return false;
}

}  // namespace t2p
