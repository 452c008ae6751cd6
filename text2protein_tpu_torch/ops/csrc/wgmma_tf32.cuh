// Hopper pieces of the f32 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu), sm_90a: `wgmma.mma_async` with TF32 operands and f32
// accumulators in 3xTF32 form, f32 TMA tiles, and the conversions in shared
// memory that TF32 wgmma needs. With those two files they replace, for f32
// and D <= 512, the Pallas TPU kernels `_flash_kernel`
// (text2protein_tpu/ops/flash.py:50) and `_flash_bwd_kernel` (:168); D > 512
// keeps the mma.sync kernels of mma_tf32x3.cuh.
//
// Bound on an H100: 3xTF32 issues three TF32 products per f32 product, so
// the route's least time is 3 x 4 B H Tq Tk D FLOPs forward and 3 x 10 B H
// Tq Tk D backward at 495 TFLOP/s (or the bytes at 3.35 TB/s): 0.052 ms
// and 0.065 ms at test_config's AttnBlock 32x32 (D = 512, T = 1024, B = 4
// and 2). Measured (NVIDIA H100 80GB HBM3, 700.00 W, scripts/flash_ab.py,
// device time): 0.396 and 0.854 ms there (SDPA 0.274 and 1.082); the notes
// of flash_fwd.cu and flash_bwd.cu give the rest.
//
// 3xTF32 on wgmma. a b is accumulated as a_hi b_hi + a_lo b_hi + a_hi b_lo
// (CUTLASS's OpMultiplyAddFastF32), which keeps f32's accuracy to a few
// ulps of the sum. Every product of the kernels takes its A operand from
// registers (the RS form), split there: hi = cvt.rna(x), lo = cvt.rna(x -
// hi). The B operand comes from shared memory, where a wgmma reads an f32
// word as TF32 by dropping its low 13 bits. So a B tile is used as it
// arrives (its truncation is its hi part) beside a second tile that holds
// the exact remainder x - trunc(x) (`lo_tile`), or, where the kernel writes
// the tile itself (a transposed operand), as hi = cvt.rna(x) and lo = x - hi.
//
// K-major only. TF32 wgmma reads both operands K-major (the transpose bits
// of the descriptors exist for 16-bit types alone). S = Q K^T and dP = dO
// V^T read K, V (and, as S^T = K Q^T, Q and dO) as they are stored. P V,
// dS K, P^T dO and dS^T Q need V, K, dO and Q with T contiguous. The
// kernels transpose those tiles in shared memory after the TMA load
// (`transpose_tile`), into the same buffers that hold the B operand's lo
// part anyway. A converted copy in device memory needs scratch, which the
// forward's entry point (whose signature is fixed) does not take; in the
// backward, the dq kernel writing dkdv's converted q and dO into its
// scratch (no second launch) made dkdv's steps plain TMA and wgmma, but
// moved twice the B bytes and gained only at D = 512 (on an H100, a few
// percent there, and a loss of 15-50% at D <= 256), so it was left out.
//
// Tiles. A (rows, D) f32 operand is loaded as boxes of 32 columns (128 bytes
// a row, `F32_BOX` columns), one TMA copy each with the 128-byte swizzle:
// box b of a tile of R rows lies at b * R * 128 bytes from the tile's base,
// every base 1024-byte aligned; element (r, c) of a box is at
// r * 128 + ((c / 4) ^ (r % 8)) * 16 + (c % 4) * 4. Columns at or past D and
// rows at or past T arrive as zeros. The descriptor of such a tile read
// K-major (wgmma_bf16.cuh's sw128_desc): 8-row groups 1024 bytes apart, the
// k-th 8-column step 32 k bytes into a box, the same byte offsets as the
// 16-column steps of bf16.
//
// Fragments. The accumulator of m64nNk8 (f32) gives warp w of the
// warpgroup rows 16 w + g and 16 w + g + 8 (g = lane / 4, t = lane % 4):
// d[i] is row 16 w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1).
// The register A operand of m64nNk8 TF32 is the m16n8k8 layout per warp:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4). An
// accumulator block of 8 columns holds columns 2 t and 2 t + 1, not t and
// t + 4, so P and dS become A fragments as {d0, d2, d1, d3}: k-slot l of a
// k-step is key 2 l (l < 4) or key 2 (l - 4) + 1. A transposed B tile puts
// its keys in that order (slots 0-3: keys 0, 2, 4, 6; slots 4-7: keys 1, 3,
// 5, 7), and the sum over the keys is the same sum.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"

namespace t2p {

constexpr int F32_BOX = 32;       // f32 columns of a TMA box (128 bytes)
constexpr int TF_MAX_D = 512;     // the largest D of the TF32 wgmma kernels

__host__ __device__ inline int f32_boxes(int d) {
  return (d + F32_BOX - 1) / F32_BOX;
}

// Whether an f32 call of (Tq, Tk, D) takes the TF32 wgmma kernels: every
// D <= 512 but the 4x4 mid block's AttnBlock (one 16-row tile each way at
// D = 256), where the mma.sync kernels' 16-row blocks took half the
// wgmma kernels' device time on an H100, forward and backward (the wgmma
// kernels' fixed latency: a 64-row tile, its TMA, the step pipeline and,
// in the backward, a cluster).
__host__ __device__ inline bool tf32_route(int tq, int tk, int d) {
  return d <= TF_MAX_D && !(d > 128 && tq <= 16 && tk <= 16);
}

// ------------------------------------------------------------ device side

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_f32x4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// byte offset of element (r, c) (c < 32) of a swizzled box
__device__ __forceinline__ uint32_t sw_off(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// the exact remainder of x below its truncation to TF32
__device__ __forceinline__ float trunc_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// An A fragment (rows 16 w + g, + 8; columns 8 kk + t, + 4 of a swizzled box
// of 64 rows at `box`) split into hi and lo TF32 parts.
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4], uint32_t box,
                                             int kk, int warp, int g, int t) {
  const int r = 16 * warp + g;
  float x[4];
  x[0] = lds_f32(box + sw_off(r, 8 * kk + t));
  x[1] = lds_f32(box + sw_off(r + 8, 8 * kk + t));
  x[2] = lds_f32(box + sw_off(r, 8 * kk + t + 4));
  x[3] = lds_f32(box + sw_off(r + 8, 8 * kk + t + 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// The A fragments of k-step j of an accumulator row block (d[4 j .. 4 j + 3]
// of 8 columns), hi and lo: slots {d0, d2, d1, d3} (see Fragments).
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int j,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {d[4 * j], d[4 * j + 2], d[4 * j + 1], d[4 * j + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - __uint_as_float(hi[i]));
  }
}

// lo = x - trunc(x) of every float of `bytes` (a multiple of 128 x 16) at
// src, to the same offsets from dst; the 128 threads of a warpgroup (ct its
// thread) share the work, each the same number of float4s: ptxas
// serializes every wgmma of a kernel that has a loop whose trip count
// differs between the threads of a warpgroup.
__device__ __forceinline__ void lo_tile(uint32_t dst, uint32_t src,
                                        uint32_t bytes, int ct) {
  const int n = (int)(bytes >> 11);
  for (int i = 0; i < n; ++i) {
    const uint32_t o = (uint32_t)(i * 128 + ct) * 16u;
    float4 v = lds_f32x4(src + o);
    v.x = trunc_lo(v.x);
    v.y = trunc_lo(v.y);
    v.z = trunc_lo(v.z);
    v.w = trunc_lo(v.w);
    sts_f32x4(dst + o, v);
  }
}

// The transpose of `nbox` boxes of a (rows, 32 * nbox) tile at `src` (box b
// at src + b * rows * 128) into K-major B operands with the rows as K:
// hi = rna(x) at dst_hi and lo = x - hi at dst_lo, each laid out as blocks
// of 32 columns x 128 bytes (32 rows of the source in k-slot order), block
// (kb, b) of key box kb = row / 32 at ((kb * nbox) + b) * 4096, so that a
// B operand of N = 32 nbox columns (all boxes at one kb) is contiguous with
// 8-row groups 1024 bytes apart. rows % 32 == 0. The 128 threads of a
// warpgroup share the work (ct its thread; the same trip count in each, as
// in lo_tile).
__device__ __forceinline__ void transpose_tile(uint32_t dst_hi,
                                               uint32_t dst_lo, uint32_t src,
                                               int rows, int nbox, int ct) {
  const int groups = rows >> 3;  // 8-row groups: one k-step each
  const int n = nbox * 32 * groups / 128;
  for (int i = 0; i < n; ++i) {
    const int e = i * 128 + ct;
    const int c = e & 31;  // consecutive threads: consecutive columns
    const int rest = e >> 5;
    const int b = rest % nbox, j = rest / nbox;
    const uint32_t box = src + (uint32_t)(b * rows * 128);
    float x[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) x[m] = lds_f32(box + sw_off(8 * j + m, c));
    // slots 0-3: keys 0, 2, 4, 6; slots 4-7: keys 1, 3, 5, 7
    float h[8], l[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const float v = x[s < 4 ? 2 * s : 2 * (s - 4) + 1];
      h[s] = __uint_as_float(tf32_rna(v));
      l[s] = v - h[s];
    }
    const int kb = (8 * j) >> 5, p = (8 * j) & 31;
    const uint32_t blk = (uint32_t)((kb * nbox + b) * 4096);
    const uint32_t o0 = blk + sw_off(c, p), o1 = blk + sw_off(c, p + 4);
    sts_f32x4(dst_hi + o0, make_float4(h[0], h[1], h[2], h[3]));
    sts_f32x4(dst_hi + o1, make_float4(h[4], h[5], h[6], h[7]));
    sts_f32x4(dst_lo + o0, make_float4(l[0], l[1], l[2], l[3]));
    sts_f32x4(dst_lo + o1, make_float4(l[4], l[5], l[6], l[7]));
  }
}

// wgmma.mma_async m64nNk8, f32 += tf32 x tf32, A from registers, B K-major
// from shared memory (N = 32, 64 by the accumulator's size). The scale-d
// predicate is 1: the accumulators are zeroed by the caller.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The three TF32 products of a 3xTF32 step: d += a_hi b_hi + a_lo b_hi +
// a_hi b_lo, with `bhi` the descriptor of B as it arrived (or rounded) and
// `blo` that of its lo tile.
template <int N>
__device__ __forceinline__ void wgmma_3x(float (&d)[N], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint64_t bhi,
                                         uint64_t blo) {
  wgmma_tf32(d, al, bhi);
  wgmma_tf32(d, ah, blo);
  wgmma_tf32(d, ah, bhi);
}

template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void fence_a(uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[j])::"memory");
}

// S (64 x N) += A B^T over the 8-column k-steps of `nbox` boxes: A a
// resident (or streamed) tile of 64 rows (box x at a + x * 8192), split in
// registers a box at a time; B `rows` rows of boxes at b (box x at
// b + x * rows * 128) with the lo tile at the same offsets from `blo`. A
// box's fragments are all loaded before its fence, and every wgmma
// instruction sits on the loop's uniform path: ptxas serializes the
// wgmmas of a kernel where a fence or a wait is conditional. Ends with
// every product complete.
template <int N>
__device__ __forceinline__ void issue_abt(float (&s)[N], uint32_t a,
                                          uint32_t b, uint32_t blo, int nbox,
                                          int rows, int warp, int g, int t) {
  uint32_t ah[4][4], al[4][4];
  for (int x = 0; x < nbox; ++x) {
    const uint32_t abox = a + (uint32_t)(x * 64 * 128);
    const uint32_t bbox = (uint32_t)(x * rows * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      load_a_split(ah[kk], al[kk], abox, kk, warp, g, t);
    fence_a(ah);
    fence_a(al);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_3x(s, ah[kk], al[kk], sw128_desc(b + bbox + kk * 32),
               sw128_desc(blo + bbox + kk * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_a(ah);
    fence_a(al);
  }
}

// The sums over the `ncl` blocks of a cluster (each holding a partial over
// its share of D) of x and y, in every block, through device memory: each
// block writes its partials (2 N floats a thread) to its slot of `buf`,
// this cluster's buffer for this inner tile (ncl slots), and after the
// cluster barrier (release and acquire at cluster scope, which orders the
// writes before the peers' reads) adds all ranks' partials in rank order,
// read from L2 (`ld.global.cg`: another SM's writes are not in this SM's
// L1), so every block holds the same bits. Buffers alternate by inner tile:
// a block rewrites its slot only after the next barrier, by which every
// peer has read it. Device memory, not the peers' shared memory, holds the
// partials so that the blocks of a cluster keep shared memory for two
// blocks an SM: with the 96 KB of a shared-memory exchange at D = 512 one
// block an SM let 30 clusters of 4 run at once on an H100, fewer than
// test_config's 32 row tiles.
template <int N>
__device__ __forceinline__ void cluster_sum(float (&x)[N], float (&y)[N],
                                            float* buf, int rank, int ncl,
                                            int ct) {
  float* mine = buf + (size_t)rank * 2 * N * 128;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mine[i * 128 + ct] = x[i];
    mine[(N + i) * 128 + ct] = y[i];
  }
  cluster_sync();
  float sx[N], sy[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sx[i] = sy[i] = 0.f;
  for (int r = 0; r < ncl; ++r) {
    if (r == rank) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        sx[i] += x[i];
        sy[i] += y[i];
      }
    } else {
      const float* src = buf + (size_t)r * 2 * N * 128;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        sx[i] += __ldcg(src + i * 128 + ct);
        sy[i] += __ldcg(src + (N + i) * 128 + ct);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = sx[i];
    y[i] = sy[i];
  }
}

// Named barrier 2 + wg among the 128 threads of warpgroup wg (barrier 0 is
// __syncthreads, 1 the bf16 kernels' exchange).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// ------------------------------------------------------------- host side

// SMs of the current device, cached per device
inline int sm_count() {
  static int cached[MAX_DEVICES] = {};
  const int slot = current_device();
  int sms = slot < 0 ? 0 : cached[slot];
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
    if (slot >= 0) cached[slot] = sms;
  }
  return sms;
}

}  // namespace t2p
