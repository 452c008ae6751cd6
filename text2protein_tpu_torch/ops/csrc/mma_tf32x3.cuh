// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// for Hopper (sm_90a): f32 products on the tensor cores in 3xTF32 form as
// `mma.sync`, cp.async tile copies, and the tile loops both kernels share.
// Which calls use it: the f32 kernels of D > 512 (`flash_fwd_kernel`,
// `flash_bwd_{dq,dkdv}_kernel`: test_config_large's D = 1024 AttnBlock);
// every f32 call with D <= 512 takes the TF32 wgmma kernels of
// wgmma_tf32.cuh, which share this header's host helpers (current_device,
// opt_in, aligned16) and nothing of its device code.
//
// 3xTF32. `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` multiplies
// TF32 operands (10 explicit mantissa bits) into an f32 accumulator. Each
// f32 operand x is split in registers into hi = tf32(x) and
// lo = tf32(x - hi), and a*b is accumulated as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi (the small terms first; a_lo*b_lo is below f32's rounding).
// That keeps f32's accuracy to within a few ulps of the sum (CUTLASS calls
// the scheme OpMultiplyAddFastF32). Shared memory holds f32 only.
//
// Fragment layouts of m16n8k8 (PTX ISA, "Matrix Fragments for mma.m16n8k8"),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, col-major):   b0 (k=t, n=g)             b1 (k=t+4, n=g)
//   C (16 x 8):             c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t) c3 (g+8, 2t+1)
//
// Shared tiles are row-major with a row stride of D + 4 floats (D % 8 == 0),
// so the fragment reads `row g, column t` of 8 rows hit 32 distinct banks,
// and every row starts on a 16-byte boundary for cp.async.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace t2p {

constexpr int NWARP = 8;             // warps per block, both kernels
constexpr int NT = NWARP * 32;       // threads per block
constexpr int ROWS = 16;             // rows of the m16n8k8 A operand

__host__ __device__ inline int pad_ld(int cols) { return cols + 4; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The hi and lo TF32 parts of an A fragment, split once where one A
// fragment meets several B fragments.
struct SplitA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ SplitA split_a(const float a[4]) {
  SplitA s;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], s.hi[i], s.lo[i]);
  return s;
}

// c += a * b in 3xTF32, with a split and b given as an f32 fragment.
__device__ __forceinline__ void mma_3xtf32(float c[4], const SplitA& a,
                                           const float b[2]) {
  uint32_t bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(c, a.lo, bh);
  mma_tf32(c, a.hi, bl);
  mma_tf32(c, a.hi, bh);
}

// A fragment of rows [0, 16) and columns [k0, k0 + 8) of a row-major tile.
__device__ __forceinline__ void load_a(float a[4], const float* s, int ld,
                                       int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + g * ld + k0 + t;
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// B fragment (k x n = 8 x 8) with B[k][n] = s[(n0 + n) * ld + k0 + k]: the
// transpose of a row-major tile, as in Q K^T.
__device__ __forceinline__ void load_bt(float b[2], const float* s, int ld,
                                        int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (n0 + g) * ld + k0 + t;
  b[0] = p[0];
  b[1] = p[4];
}

// B fragment with B[k][n] = s[(k0 + k) * ld + n0 + n]: a row-major tile
// read as it is, as in P V.
__device__ __forceinline__ void load_bn(float b[2], const float* s, int ld,
                                        int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + t) * ld + n0 + g;
  b[0] = p[0];
  b[1] = p[4 * ld];
}

// Phase-A product of one warp: c (16 x 8) += A[0:16, k] B[n0:n0+8, k]^T over
// the k-steps kp, kp + kstride, ... of `depth` (a multiple of 8), both
// operands row-major in shared memory with stride ld. The hi*hi terms and
// the small terms go to two accumulators, two independent mma chains.
__device__ __forceinline__ void mma_abt(float c[4], const float* a, int lda,
                                        const float* b, int ldb, int n0,
                                        int depth, int kp, int kstride,
                                        int lane) {
  float big[4] = {}, small[4] = {};
  for (int k0 = kp * 8; k0 < depth; k0 += kstride * 8) {
    float fa[4], fb[2];
    load_a(fa, a, lda, k0, lane);
    load_bt(fb, b, ldb, n0, k0, lane);
    const SplitA sa = split_a(fa);
    uint32_t bh[2], bl[2];
    split_tf32(fb[0], bh[0], bl[0]);
    split_tf32(fb[1], bh[1], bl[1]);
    mma_tf32(small, sa.lo, bh);
    mma_tf32(small, sa.hi, bl);
    mma_tf32(big, sa.hi, bh);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += big[i] + small[i];
}

// The same over a 16 x 16 slab (columns n0 .. n0 + 15, two fragments c0 and
// c1): each A fragment is split once for two products, and the two slabs'
// hi*hi and small terms make four independent accumulator chains.
__device__ __forceinline__ void mma_abt2(float c0[4], float c1[4],
                                         const float* a, int lda,
                                         const float* b, int ldb, int n0,
                                         int depth, int kp, int kstride,
                                         int lane) {
  float big[2][4] = {}, small[2][4] = {};
  for (int k0 = kp * 8; k0 < depth; k0 += kstride * 8) {
    float fa[4];
    load_a(fa, a, lda, k0, lane);
    const SplitA sa = split_a(fa);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float fb[2];
      load_bt(fb, b, ldb, n0 + 8 * u, k0, lane);
      uint32_t bh[2], bl[2];
      split_tf32(fb[0], bh[0], bl[0]);
      split_tf32(fb[1], bh[1], bl[1]);
      mma_tf32(small[u], sa.lo, bh);
      mma_tf32(small[u], sa.hi, bl);
      mma_tf32(big[u], sa.hi, bh);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] += big[0][i] + small[0][i];
    c1[i] += big[1][i] + small[1][i];
  }
}

// Stores a 16 x 8 accumulator fragment at columns [n0, n0 + 8) of a
// row-major shared tile of stride ld.
__device__ __forceinline__ void store_c(float* s, int ld, int n0,
                                        const float c[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* p = s + g * ld + n0 + 2 * t;
  p[0] = c[0];
  p[1] = c[1];
  p[8 * ld] = c[2];
  p[8 * ld + 1] = c[3];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issues the copy of rows [r0, r0 + rows) and columns [c0, c0 + cols) of a
// row-major (., row_len) global matrix into a shared tile of stride ld;
// rows at or past `limit` are filled with zeros. cols % 4 == 0. All threads
// of the block take part.
__device__ __forceinline__ void load_tile_async(float* dst, int ld,
                                                const float* src, int row_len,
                                                int r0, int rows, int limit,
                                                int c0, int cols) {
  const int per_row = cols >> 2;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = (e - r * per_row) << 2;
    const bool in = r0 + r < limit;
    const float* g = src + (size_t)(in ? r0 + r : 0) * row_len + c0 + c;
    cp_async16(dst + r * ld + c, g, in);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Host-side facts of a device (its SM count; a kernel's shared-memory
// opt-in, which belongs to the device's context) are cached per device, for
// the first MAX_DEVICES devices.
constexpr int MAX_DEVICES = 16;

// The current device, or -1 where it is not one of the first MAX_DEVICES.
inline int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

// Above 48 KB a block needs the opt-in; raise it to the largest size each
// kernel has been asked for on the current device (a host-side call, made
// only when it grows; `*opted` is that device's entry and starts at 0). The
// first call also asks for the largest shared memory carveout, so that the
// blocks that fit by shared memory are resident together.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, size_t* opted) {
  if (*opted > 0 && bytes <= *opted) return cudaSuccess;
  if (*opted == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *opted = bytes;
  return err;
}

// Whether every pointer is 16-byte aligned (cp.async copies 16 bytes).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p && (reinterpret_cast<uintptr_t>(p) & 15u)) return false;
  return true;
}

}  // namespace t2p
