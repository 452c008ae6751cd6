// Hopper pieces of the bf16 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu), sm_90a: `wgmma.mma_async` with bf16 operands and f32
// accumulators, TMA tile loads (`cp.async.bulk.tensor`) completing on
// `mbarrier`s, and the host-side encoding of the TMA tensor maps.
//
// Tiles. A (rows, D) bf16 operand is loaded as boxes of BC = 64 columns
// (128 bytes a row, the 128-byte swizzle) or, where D <= 32, of BC = 32
// columns (64 bytes a row, the 64-byte swizzle), each box one TMA copy: box
// b of a tile of R rows lies at b * R * 2 BC bytes from the tile's base,
// every base 1024-byte aligned, so the swizzle's XOR of address bits [4, 7)
// (128B) or [4, 6) (64B) with bits [7, 10) is the one a wgmma descriptor of
// layout "128B" or "64B" undoes. Columns at or past D and rows at or past T
// (the tensor map is (BH, T, D), so a tile never reads the next head)
// arrive as zeros: a ragged tile and the padding of D (D % BC != 0,
// D % 16 == 8 included) add exact zeros to every sum. 32-column boxes halve
// the k-steps of S (and dP) and the N of every product with P or dS at
// D = 32, where 64-column boxes multiplied 32 columns of TMA's zeros.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): start address >> 4 in
// bits [0, 14), leading byte offset >> 4 in [16, 30), stride byte offset
// >> 4 in [32, 46), layout 1 (128-byte swizzle) or 2 (64-byte) in [62, 64).
// Both offsets are the bytes of 8 rows of a box (1024 or 512):
//   K-major (Q, K, dO, V as the operands of Q K^T, dO V^T, K Q^T, V dO^T):
//     8-row groups 8 x 2 BC bytes apart (stride offset); the k-th
//     16-column step of a box starts 32 k bytes into it (the swizzle is
//     applied to the address, so the step is a plain offset).
//   MN-major (V, K, Q, dO as the B operand of P V, dS K, P^T dO, dS^T Q,
//     with the transpose bit): the BC columns of a box are the N side, its
//     rows the K side; 8-row groups of K are 8 x 2 BC bytes apart and the
//     next 16 rows of K start 2 x that on. An nBC product reads one
//     BC-column atom, so only the K-group stride is read.
//
// Fragments. The accumulator of m64nNk16 (f32) gives warp w of the
// warpgroup rows 16 w + g and 16 w + g + 8 (g = lane / 4, t = lane % 4):
// d[i] is row 16 w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 t + (i & 1),
// the C layout of m16n8k16 repeated over the 8-column blocks. The register
// A operand of the RS form has the m16n8k16 A layout per warp, so the
// accumulators of 16 columns (d[8 j .. 8 j + 7]) are, element for element,
// the A fragment of k-slice j (split_bf16 of consecutive pairs): P and dS
// go from one product to the next without shared memory, as hi + lo bf16
// halves (mma_bf16.cuh).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"

namespace t2p {

constexpr int WG_ROWS = 64;       // rows of a wgmma tile (a warpgroup's M)
constexpr int WG_MAX_D = 512;     // the largest D of the backward's wgmma kernels
constexpr int BOX_COLS = 64;      // columns of a TMA box (128 bytes of bf16)
constexpr int BOX_ROW_BYTES = 128;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ inline int nboxes(int d, int bc = BOX_COLS) {
  return (d + bc - 1) / bc;
}

// Columns of the bf16 kernels' TMA boxes for a width: 32 up to D = 32, else
// 64.
__host__ __device__ inline int box_cols(int d) { return d <= 32 ? 32 : 64; }

// Byte offsets of a wgmma kernel's shared memory from its 1024-byte aligned
// base: `nres` resident tiles of 64 rows (Q; Q and dO; K and V), `stages`
// stages of two tiles of `tile` rows, and for two warpgroups the exchange
// of the S (and dP) partial sums: two buffers (by tile parity) of `nxch`
// floats a thread per warpgroup; then the mbarriers (full and empty per
// stage for each of the stage's two tiles, one for the resident tiles) and
// two ints a stage (the forward's release counts). Rows of `rowb` bytes
// (2 BC). `total` includes the 1024 bytes of alignment slack.
struct WgLayout {
  uint32_t stage0, stage, xch, bars, total;
};

__host__ __device__ inline WgLayout wg_layout(int nres, int nbox, int tile,
                                              int stages, int nwg, int nxch,
                                              int rowb = BOX_ROW_BYTES) {
  WgLayout l;
  l.stage0 = (uint32_t)(nres * nbox * WG_ROWS * rowb);
  l.stage = (uint32_t)(2 * nbox * tile * rowb);
  l.xch = l.stage0 + stages * l.stage;
  const uint32_t xch_bytes =
      nwg > 1 ? (uint32_t)(2 * nwg * nxch * 128 * sizeof(float)) : 0u;
  l.bars = l.xch + xch_bytes;
  l.total = l.bars + 8u * (4 * stages + 1) + 8u * stages + 1024u;
  return l;
}

// ------------------------------------------------------------ device side

// 2^x by the SFU's approximation, a result below 2^-126 flushed to 0 (no
// denormal scaling around it): the bf16 kernels' exp, whose results enter
// f32 sums of terms at least 2^-24 of the largest, where such a result
// was already lost to rounding.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and `bytes` more to come from TMA copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts ~2^26 polls (seconds) traps: a copy or an arrival that never
// comes ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// Box (c0 = column, c1 = row, c2 = head) of a (BH, T, D) tensor map into
// shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The descriptor of an operand of BC-column boxes starting at `addr`:
// 128-byte swizzle for BC = 64, 64-byte for BC = 32.
template <int BC>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  static_assert(BC == 64 || BC == 32, "boxes of 64 or 32 bf16 columns");
  constexpr uint64_t group = (8 * 2 * BC) >> 4;  // 8 rows, in 16 bytes
  constexpr uint64_t layout = BC == 64 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (group << 16) | (group << 32) |
         (layout << 62);
}

// The descriptor of a 128-byte-swizzled operand starting at `addr`.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return sw_desc<64>(addr);
}

// Thread block clusters: the rank of this block in its cluster, and the
// cluster-wide barrier (every thread of every block; release and acquire
// at cluster scope, so memory writes before it, distributed shared memory
// included, are seen by the peers' reads after it).
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at shared address `addr` of this block, read in the shared
// memory of block `rank` of the cluster.
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup's wgmmas are
// still running (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence before it or the wait after it
// (CUTLASS's warpgroup_fence_operand): ptxas serializes every wgmma of a
// kernel where an accumulator or A fragment is written between the two.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barrier 1 among the `n` threads of the warpgroups that exchange a
// partial sum (barrier 0 is __syncthreads).
__device__ __forceinline__ void warpgroups_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The exchange of a partial sum between two warpgroups: each thread
// writes its N floats at buf[i * 128 + thread], and after warpgroups_sync
// adds the other warpgroup's. Both warpgroups then hold bit-equal sums
// (a + b == b + a).
template <int N>
__device__ __forceinline__ void xch_put(const float (&v)[N], float* buf,
                                        int ct) {
#pragma unroll
  for (int i = 0; i < N; ++i) buf[i * 128 + ct] = v[i];
}

template <int N>
__device__ __forceinline__ void xch_add(float (&v)[N], const float* buf,
                                        int ct) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] += buf[i * 128 + ct];
}

// The hi and lo bf16 A fragments of the k-slices of an accumulator row
// block: slice j from d[8 j .. 8 j + 7].
template <int NS>
__device__ __forceinline__ void split_acc(const float (&d)[8 * NS],
                                          uint32_t (&hi)[NS][4],
                                          uint32_t (&lo)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split_bf16(d[8 * j + 2 * q], d[8 * j + 2 * q + 1], hi[j][q], lo[j][q]);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. `wgmma_ss`: A and B from
// shared memory, both K-major (N = 16, 32, 64 by the accumulator's size).
// `wgmma_rs`: A from registers, B MN-major (N = 32, 64). The scale-d predicate
// is 1: the accumulators are zeroed by the caller.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a contiguous (bh, t, d) tensor of `elem` bytes an
// element (2: bf16, 4: f32) read in boxes of `cols` columns x `rows` rows,
// swizzled by the box's row bytes (128 or 64), zeros out of bounds.
// Encoding a map is a call into libcuda that costs microseconds of the
// host's time, which paces the small calls, so the maps of both dtypes are
// kept in one cache per thread, by (pointer, shape, dtype, box): the same
// key always encodes the same map. The cache has SETS sets of WAYS entries,
// a key's set drawn from a 64-bit mix of all its fields (the tensors of a
// call often differ only in address bits that a plain XOR fold drops),
// and a miss replaces the set's entries in turn.
inline bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int t,
                       int d, int rows, int cols, int elem) {
  struct Entry {
    const void* ptr;
    int bh, t, d, rows, cols, elem;
    CUtensorMap map;
  };
  constexpr int SETS = 128, WAYS = 4;
  thread_local Entry cache[SETS][WAYS] = {};
  thread_local uint8_t next[SETS] = {};
  auto mix = [](uint64_t x) {  // splitmix64's finalizer
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  };
  uint64_t h = mix(reinterpret_cast<uintptr_t>(ptr));
  h = mix(h ^ ((uint64_t)(uint32_t)t << 32 | (uint32_t)d));
  h = mix(h ^ ((uint64_t)(uint32_t)bh << 32 |
               (uint32_t)(rows << 16 | cols << 4 | elem)));
  const int set = (int)(h % SETS);
  for (int w = 0; w < WAYS; ++w) {
    const Entry& e = cache[set][w];
    if (e.ptr == ptr && e.bh == bh && e.t == t && e.d == d &&
        e.rows == rows && e.cols == cols && e.elem == elem) {
      memcpy(map, &e.map, sizeof(CUtensorMap));
      return true;
    }
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  // libcuda encodes a map in the calling thread's current context, which
  // a thread that never set its device (autograd's worker threads for the
  // device that is current) does not have yet: set it
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem,
                                 (cuuint64_t)t * (cuuint64_t)d * elem};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (fn(map,
         elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         3, const_cast<void*>(ptr), dims, strides, box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         cols * elem == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& e = cache[set][next[set]];
  next[set] = (uint8_t)((next[set] + 1) % WAYS);
  e.ptr = ptr;
  e.bh = bh;
  e.t = t;
  e.d = d;
  e.rows = rows;
  e.cols = cols;
  e.elem = elem;
  memcpy(&e.map, map, sizeof(CUtensorMap));
  return true;
}

}  // namespace t2p
