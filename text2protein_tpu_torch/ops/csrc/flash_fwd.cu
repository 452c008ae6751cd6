// Flash-attention forward for Hopper (sm_90a), float32 in and out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// text2protein_tpu/ops/flash.py:50 (reached through `flash_attention_fwd`).
// Same function: blockwise online-softmax attention over q (B,H,Tq,D) and
// k, v (B,H,Tk,D) with an optional (B,Tk) key mask applied as a -1e30 bias
// and p *= mask, so a fully masked row gives 0; accumulation in f32,
// out /= max(l, 1e-30), and lse = m + log(max(l, 1e-30)) per row.
//
// What bounds it on the card: 4 B H Tq Tk D FLOPs and the bytes of q, k, v,
// out and lse. At test_config's AttnBlock 32x32 (B=4, H=1, T=1024, D=512)
// that is 8.6 GFLOP and 25 MB: 0.128 ms at the f32 CUDA-core rate (67
// TFLOP/s), 0.052 ms as 3xTF32 on the tensor cores (3 x 8.6 GFLOP at 495
// TFLOP/s), the bound of this kernel's route. At the L=128 serving shapes
// (B=4, T <= 256) the bound is a few microseconds, below the launch latency
// and the wrapper's host time.
//
// Design, D <= 512 (every f32 call of the paths but test_config_large's
// D=1024): `flash_fwd_tf32_kernel` below, after the bf16 kernels, on TF32
// wgmma in 3xTF32 form (wgmma_tf32.cuh). D > 512 keeps `flash_fwd_kernel`
// here: m16n8k8 TF32 `mma.sync` in 3xTF32 form (mma_tf32x3.cuh), a block of
// 8 warps on 16 query rows and, where the grid would otherwise hold fewer
// than two blocks per SM, one chunk of >= 64 of the D output columns (grid
// z), each recomputing the scores of its rows; cp.async double-buffers the
// k/v tiles. At test_config_large's 8x8 calls (D=1024) it took 0.899 ms per
// evaluation against SDPA's 1.191 (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/flash_ab.py, device
// time by CUDA-graph replay, against the mma.sync kernels these replace and
// SDPA): the AttnBlock 32x32 of test_config (B=4, D=512) 0.396 ms a call
// (mma.sync 1.244, SDPA 0.274: the route's bound is 0.052), its 8 heads of
// 64 at 32x32 0.190 (0.381, SDPA 0.326); per test_config PC step 9.14 ms
// (23.40, SDPA 10.66); per L=128 PC step 0.653 ms (1.015, SDPA 0.868), the
// AttnBlock 16x16 there 35.6 us (55.1, SDPA 38.6). ptxas: no spill, no
// stack frame (128-228 registers).

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace t2p;

// per-call choices of the D > 512 kernel: key tile rows, pipeline stages,
// output column chunks, and the launch shape
struct FwdPlan {
  int bk, stages, nchunk, dc, ntw;
  dim3 grid;
  size_t smem;
};

size_t fwd_smem(int D, int dc, int bk, int stages) {
  const int kp = NWARP / (bk / 16);
  return sizeof(float) *
         ((size_t)ROWS * pad_ld(D) +
          (size_t)stages * bk * (pad_ld(D) + pad_ld(dc)) +
          (size_t)(kp + 1) * ROWS * pad_ld(bk) + 2 * ROWS);
}

FwdPlan plan_fwd(int B, int H, int Tq, int Tk, int D) {
  FwdPlan p{};
  const long blocks = (long)B * H * ((Tq + ROWS - 1) / ROWS);
  p.nchunk = 1;
  while (blocks * p.nchunk < 2L * sm_count() && D % (16 * p.nchunk) == 0 &&
         D / (2 * p.nchunk) >= 64)
    p.nchunk *= 2;
  p.dc = D / p.nchunk;
  p.ntw = (p.dc / 8 + NWARP - 1) / NWARP;
  int cap = 16;
  while (cap < 64 && cap < Tk) cap *= 2;
  const size_t limits[2] = {113 * 1024, 227 * 1024};
  for (size_t limit : limits)
    for (int bk = cap; bk >= 16; bk /= 2)
      if (fwd_smem(D, p.dc, bk, 2) <= limit) {
        p.bk = bk;
        p.stages = 2;
        p.smem = fwd_smem(D, p.dc, bk, 2);
        p.grid = dim3(B * H, (Tq + ROWS - 1) / ROWS, p.nchunk);
        return p;
      }
  p.bk = 16;
  p.stages = 1;
  p.smem = fwd_smem(D, p.dc, 16, 1);
  p.grid = dim3(B * H, (Tq + ROWS - 1) / ROWS, p.nchunk);
  return p;
}

template <int NTW>
__global__ void __launch_bounds__(NT, NTW <= 4 ? 2 : 1) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    int D, int dc, int bk, int stages, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = pad_ld(D), ldv = pad_ld(dc), ldp = pad_ld(bk);
  const int nwork = bk >> 4;         // 16 x 16 slabs of S per key tile
  const int kpn = NWARP / nwork;     // warps sharing one slab
  const int stage_floats = bk * (ldq + ldv);
  float* sq = smem;                              // 16 x ldq
  float* stage0 = sq + ROWS * ldq;               // stages x (k tile, v tile)
  float* spart = stage0 + stages * stage_floats; // kpn x 16 x ldp
  float* sp = spart + kpn * ROWS * ldp;          // 16 x ldp: P
  float* salpha = sp + ROWS * ldp;               // 16
  float* sl = salpha + ROWS;                     // 16

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int c0 = blockIdx.z * dc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tk + bk - 1) / bk;

  auto load_kv = [&](int it, int s) {
    float* sk = stage0 + s * stage_floats;
    load_tile_async(sk, ldq, kb, D, it * bk, bk, Tk, 0, D);
    load_tile_async(sk + bk * ldq, ldv, vb, D, it * bk, bk, Tk, c0, dc);
  };
  load_tile_async(sq, ldq, qb, D, q0, ROWS, Tq, 0, D);
  load_kv(0, 0);
  cp_async_commit();

  // online-softmax state of rows 2 * warp + r, the same in every lane
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};
  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = stages == 2 ? (it & 1) : 0;
    if (stages == 2 && it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = stage0 + st * stage_floats;
    const float* sv = sk + bk * ldq;

    {  // S slab (16 x 16) of this warp over its share of D
      const int work = warp % nwork, kp = warp / nwork;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_abt2(c0, c1, sq, ldq, sk, ldq, work * 16, D, kp, kpn, lane);
      store_c(spart + kp * ROWS * ldp, ldp, work * 16, c0, lane);
      store_c(spart + kp * ROWS * ldp, ldp, work * 16 + 8, c1, lane);
    }
    __syncthreads();

    // online softmax of rows 2 * warp and 2 * warp + 1 (bk <= 64: at most
    // two columns a lane)
    const int k0 = it * bk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 2 * warp + r;
      float s[2];
      bool live[2];
      float mx = -1e30f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        s[jj] = -1e30f;
        live[jj] = false;
        if (j < bk) {
          float a = 0.f;
          for (int kp = 0; kp < kpn; ++kp)
            a += spart[(kp * ROWS + i) * ldp + j];
          // 1 = attend; keys past Tk (a ragged last tile) count as masked
          live[jj] = k0 + j < Tk && (mb == nullptr || mb[k0 + j]);
          s[jj] = a * scale + (live[jj] ? 0.f : -1e30f);
          mx = fmaxf(mx, s[jj]);
        }
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_r[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        if (j < bk) {
          const float p = live[jj] ? expf(s[jj] - m_new) : 0.f;
          sp[i * ldp + j] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + sum;
      m_r[r] = m_new;
      if (lane == 0) salpha[i] = alpha;
    }
    __syncthreads();

    {  // O (16 x dc) = alpha * O + P V, the warps splitting the columns
      const int g = lane >> 2;
      const float a_top = salpha[g], a_bot = salpha[g + 8];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        acc[n][0] *= a_top;
        acc[n][1] *= a_top;
        acc[n][2] *= a_bot;
        acc[n][3] *= a_bot;
      }
      for (int kk = 0; kk < bk; kk += 8) {
        float fa[4];
        load_a(fa, sp, ldp, kk, lane);
        const SplitA a = split_a(fa);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int n0 = (warp + n * NWARP) * 8;
          if (n0 < dc) {
            float fb[2];
            load_bn(fb, sv, ldv, n0, kk, lane);
            mma_3xtf32(acc[n], a, fb);
          }
        }
      }
    }
    __syncthreads();
    if (stages == 1 && it + 1 < ntiles) {
      load_kv(it + 1, 0);
      cp_async_commit();
    }
  }

  if (lane == 0) {
    sl[2 * warp] = l_r[0];
    sl[2 * warp + 1] = l_r[1];
  }
  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
  float* ob = out + (size_t)bh * Tq * D;
  const float l_top = fmaxf(sl[g], 1e-30f), l_bot = fmaxf(sl[g + 8], 1e-30f);
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int n0 = (warp + n * NWARP) * 8;
    if (n0 < dc) {
      const int col = c0 + n0 + 2 * t;
      if (q0 + g < Tq)
        *reinterpret_cast<float2*>(ob + (size_t)(q0 + g) * D + col) =
            make_float2(acc[n][0] / l_top, acc[n][1] / l_top);
      if (q0 + g + 8 < Tq)
        *reinterpret_cast<float2*>(ob + (size_t)(q0 + g + 8) * D + col) =
            make_float2(acc[n][2] / l_bot, acc[n][3] / l_bot);
    }
  }
  if (blockIdx.z == 0 && lane == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + 2 * warp + r;
      if (i < Tq)
        lse[(size_t)bh * Tq + i] = m_r[r] + logf(fmaxf(l_r[r], 1e-30f));
    }
  }
}


using FwdKernel = void (*)(const float*, const float*, const float*,
                           const unsigned char*, float*, float*, int, int,
                           int, int, int, int, int, float);

// every instantiation of the D > 512 kernel, by NTW = 1, 2, 4, 8, 16
constexpr FwdKernel KERNELS[] = {flash_fwd_kernel<1>, flash_fwd_kernel<2>,
                                 flash_fwd_kernel<4>, flash_fwd_kernel<8>,
                                 flash_fwd_kernel<16>};
constexpr int NKERNELS = sizeof(KERNELS) / sizeof(KERNELS[0]);

// index into KERNELS of a plan
int kernel_index(const FwdPlan& p) {
  return p.ntw <= 1 ? 0 : p.ntw <= 2 ? 1 : p.ntw <= 4 ? 2 : p.ntw <= 8 ? 3 : 4;
}

// Sets the kernel's shared-memory attributes on the current device once and
// whenever a call needs more than before.
cudaError_t prepare(int idx, size_t smem) {
  static size_t opted[MAX_DEVICES][NKERNELS] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  return opt_in(KERNELS[idx], smem, &opted[dev][idx]);
}

bool valid_shape(int B, int H, int Tq, int Tk, int D) {
  return D > 0 && D % 8 == 0 && D <= 1024 && B > 0 && H > 0 && Tq > 0 &&
         Tk > 0;
}

}  // namespace

// ------------------------------------------------------------------ bf16
//
// The same function on bf16 q, k, v (the TPU kernel `_flash_kernel`
// upcasts them to f32 and writes `out` in the input's dtype, `lse` in f32):
// S = Q K^T and the online softmax in f32, the scale and the -1e30 mask
// bias on the f32 scores, p *= mask (a dead row gives 0 and lse -1e30),
// O = P V accumulated in f32 with P entering at f32 accuracy (hi + lo bf16
// halves, wgmma_bf16.cuh), out rounded to bf16 once, lse f32.
//
// What bounds it on the card: at the N=256 serving shapes (B=4, T <= 1024,
// H*D = 512) one call moves at most 16.8 MB of bf16 (5.0 us at 3.35 TB/s)
// and does at most 4 B H Tq Tk D = 8.6 GFLOP (8.7 us at 989 TFLOP/s), both
// at the AttnBlock 32x32 (H=1, T=1024, D=512). The mma work this design
// issues there is S once per column chunk (two: 8.6 GFLOP) and P V twice
// (hi and lo, 8.6 GFLOP): 17.4 us. At the L=128 shapes and at
// test_config_large's 8x8 calls (B=1, T=64, D=1024) the bound is a few
// microseconds: those calls are latency-bound.
//
// Design: every width on `wgmma`. A block owns 64 query rows (D > 64) or
// 128 (D <= 64) and walks the keys.
//   * TMA keeps K and V tiles in flight (K and V each with a full and an
//     empty mbarrier a stage; four stages at D <= 64, two above); the Q
//     tile is loaded once. A slot is refilled once every warp has released
//     it, by thread 0 (D > 64) or by the last warp to release it (D <= 64,
//     where the two warpgroups own separate rows and waiting would run
//     them in step): a producer warp of its own would be a ninth warp,
//     and three warps in one of the SM's four register partitions cap
//     every thread at 168 registers (ptxas spilled O).
//     TMA's zero fill replaces the row limit of ragged tiles and pads D to
//     the boxes: 32 columns (64-byte swizzle) at D <= 32, so the L=128
//     heads of 32 issue half the k-steps of S and N = 32 products with P,
//     else 64 (wgmma_bf16.cuh).
//   * S = Q K^T is an SS wgmma (m64nBKk16, both operands K-major in shared
//     memory), O += P V an RS wgmma (m64nBCk16): P in registers as hi and
//     lo halves, two wgmmas into one accumulator, V read MN-major through
//     the transpose bit. The softmax runs in log2 units, one `ex2.approx.
//     ftz` a score (exp2f's denormal handling around the SFU cost a
//     quarter of the L=128 calls' time); a tile whose keys are all live
//     skips the mask's selects; a fully masked row keeps lse = -1e30.
//   * D > 64 (the AttnBlocks, D = 256 and 512; test_config_large's heads of
//     128): two warpgroups. Each computes S over its half of the D steps;
//     the partial sums meet in shared memory (one named barrier a tile,
//     buffers by tile parity), so both warpgroups hold S. Each runs the
//     same online softmax and owns half of the block's boxes of O (256
//     columns at D = 512: 128 f32 registers a thread). Where the row tiles
//     leave half the SMs idle, the boxes of O are split over grid z into
//     chunks of two or more boxes, each block computing S over all of D
//     (the L=128 AttnBlock 16x16 at B=16: 64 row tiles, 128 blocks; the
//     N=256 AttnBlock 32x32 at B=4 likewise; its 16x16 and 8x8: four
//     chunks). Key tiles of 64 up to D = 256 (over more than 32 keys: the
//     L=128 4x4 mid block's 16 keys keep 32), of 32 above, where Q and two
//     stages of 64-key K and V tiles would not fit. The tile loop is
//     pipelined: S(it + 1) and P(it) V(it) are issued together, and the
//     exchange and softmax of S(it + 1) run while P(it) V(it) does.
//     Shared memory at D = 512, 32-key tiles: Q 64 KB +
//     2 stages x (K 32 KB + V 32 KB) + the S exchange (2 parities x 2
//     warpgroups x 16 floats x 128 threads, 32 KB) = 224 KB, + 1 KB of
//     alignment and the mbarriers: 230,472 of 232,448 bytes, one block of
//     256 threads an SM; 189 registers.
//   * D > 512 (test_config_large's 8x8 AttnBlock in bf16, D = 1024, the
//     most the JAX rule admits): the same kernel on a thread block cluster
//     of two blocks (grid z, `cudaLaunchKernelEx`), block r loading,
//     multiplying and owning the r-th half of D's boxes (the D = 512
//     layout, unchanged). The four partial sums of S (two blocks x two
//     warpgroups) meet through distributed shared memory: each warpgroup
//     writes its own, and after one cluster barrier every thread adds the
//     four in one fixed order, so both blocks hold bit-equal S and the
//     same softmax; a last cluster barrier keeps a block's shared memory
//     alive until its peer has read it. (At D = 256 and 512 the cluster
//     lost to one block: a cluster barrier every 32-key tile against one
//     named barrier, 31.1 against 22.3 us at the L=128 AttnBlock 16x16.)
//   * D <= 64 (self- and cross-attention, heads of 32 and 64): a block
//     owns 128 query rows, each of its two warpgroups 64 of them and all
//     of D, sharing every K and V tile; 64-key tiles (32 over at most 32
//     keys, the 16-token caption), two blocks an SM (118 registers at
//     D = 64). Its tile loop runs S, softmax and P V in turn (pipelined as
//     the D-split loop, on 32-key tiles to keep two blocks an SM, it was
//     slower: 58.4 against 46.4 us at N=256's heads of 64 at 32x32).
//   * The key mask is read once per tile into a bit set per thread (the
//     2 BK / 8 keys its accumulator columns hold), not per score.
//
// Measured against the previous design and SDPA on an H100 (device time
// per step of each bf16 path, scripts/flash_ab.py --dtype bf16): PERF.md
// section 6. ptxas: no spill, no stack frame.

namespace {

using namespace t2p;


// S (64 x BK) += Q K^T over this warpgroup's 16-column steps of D: with
// DSPLIT the steps [ks0, ks1) of its half of the block's boxes, else the
// whole BC-column box (D <= BC; the columns past D are TMA's zeros).
template <bool DSPLIT, int BC, int NS>
__device__ __forceinline__ void issue_s(float (&sc)[NS], uint32_t sq,
                                        uint32_t sk, uint32_t ktile,
                                        int ks0, int ks1) {
  constexpr int SPB = BC / 16;            // 16-column steps of a box
  constexpr int SHIFT = BC == 64 ? 2 : 1;  // log2(SPB)
  if (!DSPLIT) {
#pragma unroll
    for (int kk = 0; kk < SPB; ++kk)
      wgmma_ss(sc, sw_desc<BC>(sq + kk * 32), sw_desc<BC>(sk + kk * 32));
  } else {
    for (int kk = ks0; kk < ks1; ++kk)
      wgmma_ss(sc,
               sw_desc<BC>(sq + (kk >> SHIFT) * WG_ROWS * 2 * BC +
                           (kk & (SPB - 1)) * 32),
               sw_desc<BC>(sk + (kk >> SHIFT) * ktile +
                           (kk & (SPB - 1)) * 32));
  }
}

// O (this warpgroup's nob boxes) += P V: P as hi + lo A fragments per
// 16-key slice, V MN-major.
template <int BC, int NOB, int NA, int NSL>
__device__ __forceinline__ void issue_pv(float (&o)[NOB][NA],
                                         uint32_t (&ph)[NSL][4],
                                         uint32_t (&pl)[NSL][4], uint32_t sv,
                                         uint32_t ktile, int ob0, int nob) {
#pragma unroll
  for (int n = 0; n < NOB; ++n)
    if (n < nob) {
#pragma unroll
      for (int j = 0; j < NSL; ++j) {
        const uint64_t db =
            sw_desc<BC>(sv + (ob0 + n) * ktile + j * 16 * 2 * BC);
        wgmma_rs(o[n], pl[j], db);
        wgmma_rs(o[n], ph[j], db);
      }
    }
}

// The scale and mask bias on one tile of S, then its share of the online
// softmax of rows g and g + 8: the new row maxima and, in place, P and its
// row sums. Bit 2 j + e of `live` is column 8 j + 2 t + e (all ones: a
// whole tile of live keys, the selects left out). The scores are in log2
// units (scale2 = scale * log2(e)), so P is one exp2 of a difference: the
// maxima m_r, m_new are log2(e) times the JAX kernel's. FTZ (the bf16
// kernels): exp2_ftz.
template <bool FTZ = false, int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], uint32_t live,
                                             float scale2,
                                             const float (&m_r)[2],
                                             float (&m_new)[2],
                                             float (&sum)[2]) {
  const bool all = FTZ && live == ~0u;
  float mx[2] = {-1e30f, -1e30f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool lv = all || ((live >> (2 * (i >> 2) + (i & 1))) & 1u);
    sc[i] = all ? sc[i] * scale2 : fmaf(sc[i], scale2, lv ? 0.f : -1e30f);
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    m_new[r] = fmaxf(m_r[r], mx[r]);
    sum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool lv = all || ((live >> (2 * (i >> 2) + (i & 1))) & 1u);
    const float d = sc[i] - m_new[(i >> 1) & 1];
    const float p = lv ? (FTZ ? exp2_ftz(d) : exp2f(d)) : 0.f;
    sc[i] = p;
    sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
}

// The wgmma forward: two warpgroups, BK keys a tile, BC-column boxes, at
// most NOB boxes of O a warpgroup; with DSPLIT they split the D steps and
// boxes of one 64-row tile, else each owns 64 rows. With DSPLIT a thread
// block cluster of CL blocks splits D first (block r of the cluster loads,
// multiplies and owns the r-th share of the boxes), and the four (CL = 2)
// partial sums of S meet through distributed shared memory. With two
// warpgroups the tile loop is software-pipelined: iteration `it` issues
// S(it + 1) and then O += P(it) V(it), and while the second runs exchanges
// and softmaxes S(it + 1). K and V have barriers of their own, so K(it +
// 1)'s slot is refilled once S(it + 1) is done, a full iteration before
// V(it)'s.
constexpr int NWG = 2;  // warpgroups of a forward block

template <int BK, int NOB, bool DSPLIT, int BC, int CL, int ST>
__global__ void __launch_bounds__(NWG * 128, DSPLIT ? 1 : 2)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const unsigned char* __restrict__ mask,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int H, int Tq, int Tk, int D, float scale) {
  constexpr int NS = BK / 2;  // S accumulator floats a thread
  constexpr int NA = BC / 2;  // accumulator floats of one box of O
  constexpr int S = ST;
  constexpr int QT = DSPLIT ? 1 : NWG;  // 64-row Q tiles of the block
  constexpr uint32_t ROWB = 2 * BC;
  constexpr int SPB = BC / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this block's share of the boxes: nbb boxes from bb0 (all of them
  // without a cluster); the layout holds the largest share
  const int nball = nboxes(D, BC), nbs = (nball + CL - 1) / CL;
  const int rank = CL > 1 ? cluster_rank() : 0;
  const int bb0 = rank * nbs, nbb = min(nbs, nball - bb0);
  const WgLayout L = wg_layout(QT, nbs, BK, S, DSPLIT ? NWG : 1, NS, ROWB);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base, st0 = base + L.stage0, bar = base + L.bars;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L.xch);
  const int bh = blockIdx.x, q0 = blockIdx.y * QT * WG_ROWS;
  const int ntiles = (Tk + BK - 1) / BK;
  const uint32_t ktile = BK * ROWB;     // bytes of one box of a tile
  const uint32_t half = nbs * ktile;    // bytes between a K and a V tile
  const uint32_t bytes = nbb * ktile;   // bytes this block loads a tile
  const int lane = threadIdx.x & 31;
  // mbarriers of tile t: K full, V full, K empty, V empty; then Q's
  auto fk = [&](int t) { return bar + 8 * (t % S); };
  auto fv = [&](int t) { return bar + 8 * (S + t % S); };
  auto ek = [&](int t) { return bar + 8 * (2 * S + t % S); };
  auto ev = [&](int t) { return bar + 8 * (3 * S + t % S); };
  const uint32_t bar_q = bar + 32 * S;
  auto k_at = [&](int t) { return st0 + (t % S) * L.stage; };
  auto v_at = [&](int t) { return st0 + (t % S) * L.stage + half; };

  // thread 0 issues the first copies (and with DSPLIT every copy)
  const bool issuer = threadIdx.x == 0;
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t full,
                  int t) {
    mbar_expect_tx(full, bytes);
    for (int b = 0; b < nbb; ++b)
      tma_load(dst + b * ktile, map, full, (bb0 + b) * BC, t * BK, bh);
  };
  // per slot, the warps that have released K (or V) of its tile (D <= 64)
  int* kcnt = reinterpret_cast<int*>(smem_raw + (base - raw) + L.bars +
                                     8 * (4 * S + 1));
  int* vcnt = kcnt + S;
  // a warp's release of K (or V) of tile t; the slot is then refilled with
  // tile t + S once every warp has released it. D <= 64: by the last warp
  // to release it, so no thread waits for the others (a waiting thread 0
  // held its whole warpgroup at the next wgmma and ran the block's two
  // warpgroups, which own separate rows, in step: 46.2 against 42.6 us at
  // N=256's heads of 64 at 32x32 on an H100). With DSPLIT, whose
  // warpgroups meet every tile in the exchange anyway, by thread 0 (the
  // last-warp refill measured 95.9 us at the AttnBlock 32x32, thread 0
  // 85.6, in separate runs).
  auto release = [&](const CUtensorMap* map, uint32_t empty, uint32_t dst,
                     uint32_t full, int* cnt, int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
    if (DSPLIT) {
      if (issuer && t + S < ntiles) {
        mbar_wait(empty, (t / S) & 1);
        load(map, dst, full, t + S);
      }
    } else if (lane == 0 && t + S < ntiles &&
               atomicAdd(cnt + t % S, 1) == 4 * NWG - 1) {
      // every warp arrived before it counted: the phase is complete
      mbar_wait(empty, (t / S) & 1);
      cnt[t % S] = 0;
      load(map, dst, full, t + S);
    }
  };
  if (issuer) {
    for (int i = 0; i < 4 * S; ++i)
      mbar_init(bar + 8 * i, i < 2 * S ? 1 : 4 * NWG);
    mbar_init(bar_q, 1);
    mbar_fence_init();
    for (int i = 0; i < 2 * S; ++i) kcnt[i] = 0;
  }
  __syncthreads();
  if (issuer) {
    mbar_expect_tx(bar_q, QT * nbb * WG_ROWS * ROWB);
    for (int w = 0; w < QT; ++w)
      for (int b = 0; b < nbb; ++b)
        tma_load(sq + (w * nbs + b) * WG_ROWS * ROWB, &tm_q, bar_q,
                 (bb0 + b) * BC, q0 + w * WG_ROWS, bh);
    for (int t = 0; t < S && t < ntiles; ++t) {
      load(&tm_k, k_at(t), fk(t), t);
      load(&tm_v, v_at(t), fv(t), t);
    }
  }

  // the warpgroup, broadcast from lane 0 so that the compiler sees it (and
  // the k-step bounds and box counts drawn from it) uniform across the
  // warp: wgmma in a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int ct = threadIdx.x & 127;
  const int warp = ct >> 5, g = lane >> 2, t = lane & 3;
  // this warpgroup's Q tile, 16-column steps of S and boxes of O: with
  // DSPLIT a half of the block's steps and of its chunk's boxes of its one
  // Q tile (local box indices in shared memory; without a cluster, grid z
  // splits O's boxes into chunks, each block computing S over all of D),
  // else its own 64 rows and all of D
  const uint32_t sqw = sq + (DSPLIT ? 0 : wg * nbs * WG_ROWS * ROWB);
  const int row0 = q0 + (DSPLIT ? 0 : wg * WG_ROWS);
  const int nsp = DSPLIT ? NWG : 1;
  const int nks = min((D + 15) >> 4, (bb0 + nbb) * SPB) - bb0 * SPB;
  const int kper = (nks + nsp - 1) / nsp;
  const int ks0 = DSPLIT ? wg * kper : 0, ks1 = min(nks, ks0 + kper);
  const int nz = CL > 1 ? 1 : gridDim.z, zc = CL > 1 ? 0 : blockIdx.z;
  const int zper = (nbb + nz - 1) / nz, zb0 = zc * zper;
  const int nzb = min(zper, nbb - zb0);  // boxes of O of this block
  const int oper = (nzb + nsp - 1) / nsp;
  const int ob0 = zb0 + (DSPLIT ? wg * oper : 0);
  const int nob = min(oper, nzb - (ob0 - zb0));
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const float scale2 = scale * LOG2E;

  // the live keys of tile `it` among this thread's columns
  auto live_bits = [&](int it) {
    if (mb == nullptr && (it + 1) * BK <= Tk) return ~0u;
    uint32_t live = 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = it * BK + 8 * j + 2 * t + e;
        if (key < Tk && (mb == nullptr || mb[key])) live |= 1u << (2 * j + e);
      }
    return live;
  };
  // with DSPLIT, adds the other partial sums of S (buffers by parity): the
  // other warpgroup's through shared memory; with a cluster, every
  // warpgroup's of every block through distributed shared memory, summed
  // in one fixed order, so that all of them hold bit-equal sums
  auto exchange = [&](float (&sc)[NS], int it) {
    if (DSPLIT) {
      float* buf = xch + (it & 1) * NWG * NS * 128;
      xch_put(sc, buf + wg * NS * 128, ct);
      if (CL == 1) {
        warpgroups_sync(NWG * 128);
        xch_add(sc, buf + (1 - wg) * NS * 128, ct);
      } else {
        cluster_sync();
        const uint32_t b0 = smem_u32(buf) + 4 * ct;
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = 0.f;
        for (int r = 0; r < CL; ++r)
#pragma unroll
          for (int w = 0; w < NWG; ++w)
#pragma unroll
            for (int i = 0; i < NS; ++i)
              sc[i] += ld_cluster(b0 + 4 * ((w * NS + i) * 128), r);
      }
    }
  };

  float o[NOB][NA];
#pragma unroll
  for (int n = 0; n < NOB; ++n)
#pragma unroll
    for (int i = 0; i < NA; ++i) o[n][i] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};  // rows g, g + 8
  float m_new[2], sum[2];
  float sc[NS];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];

  if (!DSPLIT) {
    // D <= 64: the warpgroups own separate rows and several blocks share
    // an SM and hide each other's latency, so the tile loop runs S,
    // softmax and P V in turn (pipelining it cost registers and a block
    // per SM)
    mbar_wait(bar_q, 0);
    for (int it = 0; it < ntiles; ++it) {
      mbar_wait(fk(it), (it / S) & 1);
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      fence_regs(sc);  // zeroed before the fence, not sunk past it
      wgmma_fence();
      issue_s<DSPLIT, BC>(sc, sqw, k_at(it), ktile, ks0, ks1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(&tm_k, ek(it), k_at(it), fk(it), kcnt, it);
      softmax_tile<true>(sc, live_bits(it), scale2, m_r, m_new, sum);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f(m_r[r] - m_new[r]);
        l_r[r] = l_r[r] * alpha[r] + sum[r];
        m_r[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < NOB; ++n)
#pragma unroll
        for (int i = 0; i < NA; ++i) o[n][i] *= alpha[(i >> 1) & 1];
      split_acc(sc, ph, pl);
      mbar_wait(fv(it), (it / S) & 1);
#pragma unroll
      for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      issue_pv<BC>(o, ph, pl, v_at(it), ktile, ob0, nob);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
      fence_regs(ph);
      fence_regs(pl);
      release(&tm_v, ev(it), v_at(it), fv(it), vcnt, it);
    }
  } else {
    // S(0) and its softmax
    mbar_wait(bar_q, 0);
    mbar_wait(fk(0), 0);
  #pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    fence_regs(sc);  // zeroed before the fence, not sunk past it
    wgmma_fence();
    issue_s<DSPLIT, BC>(sc, sqw, k_at(0), ktile, ks0, ks1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    release(&tm_k, ek(0), k_at(0), fk(0), kcnt, 0);
    exchange(sc, 0);
    softmax_tile<true>(sc, live_bits(0), scale2, m_r, m_new, sum);
  #pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] = sum[r];
      m_r[r] = m_new[r];
    }
    split_acc(sc, ph, pl);

    for (int it = 0; it + 1 < ntiles; ++it) {
      mbar_wait(fk(it + 1), ((it + 1) / S) & 1);
      mbar_wait(fv(it), (it / S) & 1);
  #pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.f;
      fence_regs(sc);
  #pragma unroll
      for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      issue_s<DSPLIT, BC>(sc, sqw, k_at(it + 1), ktile, ks0, ks1);
      wgmma_commit();
      issue_pv<BC>(o, ph, pl, v_at(it), ktile, ob0, nob);
      wgmma_commit();
      wgmma_wait<1>();  // S(it + 1) is done; P(it) V(it) may still run
      fence_regs(sc);
      release(&tm_k, ek(it + 1), k_at(it + 1), fk(it + 1), kcnt, it + 1);
      exchange(sc, it + 1);
      softmax_tile<true>(sc, live_bits(it + 1), scale2, m_r, m_new, sum);
      wgmma_wait<0>();
  #pragma unroll
      for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
      fence_regs(ph);
      fence_regs(pl);
      release(&tm_v, ev(it), v_at(it), fv(it), vcnt, it);
      float alpha[2];
  #pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f(m_r[r] - m_new[r]);
        l_r[r] = l_r[r] * alpha[r] + sum[r];
        m_r[r] = m_new[r];
      }
  #pragma unroll
      for (int n = 0; n < NOB; ++n)
  #pragma unroll
        for (int i = 0; i < NA; ++i) o[n][i] *= alpha[(i >> 1) & 1];
      split_acc(sc, ph, pl);
    }

    // the last P V
    mbar_wait(fv(ntiles - 1), ((ntiles - 1) / S) & 1);
  #pragma unroll
    for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    issue_pv<BC>(o, ph, pl, v_at(ntiles - 1), ktile, ob0, nob);
    wgmma_commit();
    wgmma_wait<0>();
  #pragma unroll
    for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
    // the other blocks of the cluster may still read this one's partials
    if (CL > 1) cluster_sync();
  }

  bf16* ob = out + (size_t)bh * Tq * D;
  const int row = row0 + 16 * warp + g;
  const float l_div[2] = {fmaxf(l_r[0], 1e-30f), fmaxf(l_r[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < NOB; ++n)
    if (n < nob) {
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = (bb0 + ob0 + n) * BC + 8 * (i >> 2) + 2 * t;
        if (row + 8 * r < Tq && col < D)
          *reinterpret_cast<uint32_t*>(ob + (size_t)(row + 8 * r) * D +
                                       col) =
              pack_bf16(o[n][i] / l_div[r], o[n][i + 1] / l_div[r]);
      }
    }
  // lse = m + log(l) in natural units; a fully masked row keeps the JAX
  // kernel's m = -1e30 exactly (its log2-unit maximum never left -1e30)
  if ((!DSPLIT || (wg == 0 && rank == 0 && zc == 0)) && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < Tq)
        lse[(size_t)bh * Tq + row + 8 * r] =
            (m_r[r] <= -1e30f ? -1e30f : m_r[r] * LN2) + logf(l_div[r]);
  }
}

using FwdWgKernel = void (*)(const CUtensorMap, const CUtensorMap,
                             const CUtensorMap, const unsigned char*, bf16*,
                             float*, int, int, int, int, float);

// D <= 32 and D <= 64 (two warpgroups on 64 rows each, boxes of 32 and 64
// columns, 4 stages) on 64-key tiles, and on 32-key tiles over at most 32
// keys (the 16-token caption: half the padded S and P V of a 64-key
// tile); 64 < D <= 256 over more than 32 keys (two warpgroups splitting
// D, 64-key tiles, up to 2 boxes of O each); 64 < D <= 512 (32-key tiles,
// up to 4 boxes of O each); then 512 < D <= 1024 (the same on a cluster
// of two blocks splitting D); 2 stages
constexpr FwdWgKernel WG_KERNELS[] = {
    flash_fwd_wgmma_kernel<64, 1, false, 32, 1, 4>,
    flash_fwd_wgmma_kernel<64, 1, false, 64, 1, 4>,
    flash_fwd_wgmma_kernel<32, 1, false, 32, 1, 4>,
    flash_fwd_wgmma_kernel<32, 1, false, 64, 1, 4>,
    flash_fwd_wgmma_kernel<64, 2, true, 64, 1, 2>,
    flash_fwd_wgmma_kernel<32, 4, true, 64, 1, 2>,
    flash_fwd_wgmma_kernel<32, 4, true, 64, 2, 2>};
constexpr int NWG_KERNELS = sizeof(WG_KERNELS) / sizeof(WG_KERNELS[0]);
constexpr int WG_KERNEL_STAGES[] = {4, 4, 4, 4, 2, 2, 2};

struct WgPlan {
  int nwg, tile, rows, chunks, idx, threads, box, cluster, stages;
  dim3 grid;
  size_t smem;
};

void plan_fwd_wg(WgPlan& p, int B, int H, int Tq, int Tk, int D) {
  const bool narrow = D <= 64;
  // 64-key tiles (a 64 x 64 S) up to D = 256 where the keys fill them
  const bool wide_s = !narrow && D <= 256 && Tk > 32;
  p.box = box_cols(D);
  p.cluster = D > WG_MAX_D ? 2 : 1;
  p.nwg = NWG;
  const bool short_k = narrow && Tk <= 32;  // 32-key tiles
  p.tile = (narrow && !short_k) || wide_s ? 64 : 32;
  p.rows = narrow ? 2 * WG_ROWS : WG_ROWS;
  p.idx = narrow ? (p.box == 32 ? 0 : 1) + (short_k ? 2 : 0)
                 : wide_s ? 4 : p.cluster == 1 ? 5 : 6;
  p.stages = WG_KERNEL_STAGES[p.idx];
  // D-split without a cluster: O's boxes in chunks over grid z while the
  // row tiles leave half the SMs idle, at least one box a warpgroup
  p.chunks = 1;
  const int nbox = nboxes(D, p.box);
  const long tiles = (long)B * H * ((Tq + WG_ROWS - 1) / WG_ROWS);
  if (!narrow && p.cluster == 1)
    while (tiles * p.chunks * 2 <= sm_count() && nbox >= 4 * p.chunks)
      p.chunks *= 2;
  p.threads = 128 * p.nwg;
  p.grid = dim3(B * H, (Tq + p.rows - 1) / p.rows, p.cluster * p.chunks);
  const int nbs = (nboxes(D, p.box) + p.cluster - 1) / p.cluster;
  p.smem = wg_layout(p.rows / WG_ROWS, nbs, p.tile, p.stages,
                     narrow ? 1 : p.nwg, p.tile / 2, 2 * p.box)
               .total;
}

cudaError_t prepare_wg(int idx, size_t smem) {
  static size_t opted[MAX_DEVICES][NWG_KERNELS] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  return opt_in(WG_KERNELS[idx], smem, &opted[dev][idx]);
}

// Blocks of the plan's kernel an SM holds, -1 where it cannot say.
int per_sm_wg(const WgPlan& w) {
  int per_sm = -1;
  if (prepare_wg(w.idx, w.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, WG_KERNELS[w.idx], w.threads, w.smem) != cudaSuccess)
    return -1;
  return per_sm;
}

}  // namespace

// As t2p_flash_fwd_f32, with q, k, v and out bf16 (lse stays float32).
extern "C" int t2p_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, void* lse,
                                  int B, int H, int Tq, int Tk, int D,
                                  float scale, void* stream) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgPlan w{};
  plan_fwd_wg(w, B, H, Tq, Tk, D);
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, B * H, Tq, D, WG_ROWS, w.box, 2) ||
      !tensor_map(&mk, k, B * H, Tk, D, w.tile, w.box, 2) ||
      !tensor_map(&mv, v, B * H, Tk, D, w.tile, w.box, 2))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_wg(w.idx, w.smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  if (w.cluster == 1) {
    WG_KERNELS[w.idx]<<<w.grid, w.threads, w.smem, s>>>(
        mq, mk, mv, mp, op, lp, H, Tq, Tk, D, scale);
    return (int)cudaGetLastError();
  }
  // the blocks of a row tile's cluster along z
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = w.grid;
  cfg.blockDim = dim3(w.threads, 1, 1);
  cfg.dynamicSmemBytes = w.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)w.cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, WG_KERNELS[w.idx], mq, mk, mv, mp, op, lp,
                           H, Tq, Tk, D, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The bf16 kernel's launch plan: {warpgroups, column chunks (blocks per
// row tile, each computing S), pipeline stages, inner tile rows, rows a
// block owns, blocks, dynamic shared bytes, blocks per SM, threads per
// block, wgmma (1), box columns (32 or 64), blocks of a cluster (1 or 2,
// splitting D)}.
extern "C" int t2p_flash_fwd_bf16_plan(int B, int H, int Tq, int Tk, int D,
                                       int* out) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  WgPlan w{};
  plan_fwd_wg(w, B, H, Tq, Tk, D);
  const int v[12] = {w.nwg, w.chunks, w.stages, w.tile, w.rows,
                     (int)(w.grid.x * w.grid.y * w.grid.z), (int)w.smem,
                     per_sm_wg(w), w.threads, 1, w.box, w.cluster};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// ------------------------------------------------------- f32, TF32 wgmma
//
// The f32 forward for D <= 512: TF32 wgmma in 3xTF32 form, TMA tiles, the
// transposes and lo tiles of the B operands made in shared memory
// (wgmma_tf32.cuh says why the operands look as they do).
//
// Design. A block owns 64 query rows and a chunk of up to NOB 32-column
// boxes of O (grid z; 8 boxes, 256 columns, are 128 f32 registers a
// thread); Q stays in shared memory for the whole walk of the keys (all of
// D). Up to D = 128 the block is one warpgroup; above, two warpgroups split
// the key tiles (tiles w, w + 2, ...), each with its own TMA rings, online
// softmax state and O, sharing Q, and the first merges the second's
// (m, l, O) at the end in a fixed order: 8 warps an SM where one block of
// 4 left the tensor cores idle through each step's barriers and
// conversions (on an H100 it cut the AttnBlock 16x16 at L=128, D = 256,
// by about 40%). A warpgroup walks its key tiles in steps, each one stage
// of one of two TMA rings:
//   * K steps: `kc` boxes of the K tile. The warpgroup writes their lo
//     tile, then S (64 x BK) += Q K^T over those boxes as RS wgmmas: Q's A
//     fragments are read from the resident tile and split in registers a
//     box at a time, K read as it arrived (hi) and from the lo tile.
//   * the online softmax of S (log2 units, one exp2f a score; the key mask
//     read once a tile into a bit set per thread), P split into hi and lo
//     A fragments in registers.
//   * V steps: `vc` boxes of the V tile, transposed into Vt hi and lo tiles
//     (keys in k-slot order), then O (those boxes) += P V as RS wgmmas.
// A slot is refilled by the warpgroup's thread 0 `nst` (2 or 3) steps
// ahead, as soon as the warpgroup is done with it.
// Sizes: BK = 64 keys a tile for D <= 64 (a block then holds 2 boxes of O),
// 32 above. The plan takes the largest steps that fit (every step costs
// two barriers and a drain of the wgmma pipeline), then a third slot: 80
// KB at D = 32 (kc 1, vc 1, three slots), 96 KB at D = 64 (kc 2, vc 1),
// 112 KB at D = 128 (kc 4, vc 2): two blocks an SM; one block of two
// warpgroups at D = 256 (224 KB, kc 4, vc 2) and at D = 512 (208 KB, kc 2,
// vc 1: Q alone is 128 KB). Where the grid would leave SMs empty, the
// blocks of a row tile split O's boxes (grid z), each computing S: the
// AttnBlock 16x16 at L=128 (16 row tiles) runs 128 blocks of one box. At
// D = 512 the two z-chunks of 256 columns each compute S: S twice per
// 64-row tile (the old kernel: per 16 rows, twice).
// What holds it back at D = 512: every K and V tile is converted (lo
// tile, transpose) by each block that reads it, with a barrier a step; a
// converted copy made once in device memory needs a scratch buffer that
// this entry point does not take.

namespace {

using namespace t2p;

// Byte offsets of the forward's shared memory from its 1024-byte aligned
// base: Q (nbq boxes of 64 rows), then per warpgroup nst K slots of kc
// boxes, the K lo tile, nst V slots of vc boxes, Vt hi and Vt lo (`wg`
// bytes a warpgroup), then the mbarriers (Q; K full x nst and V full x nst
// a warpgroup). The dynamic shared memory of a block with no static shared
// memory starts 1024-byte aligned (at offset 1024, past the block's
// reserved kilobyte), which the kernel checks.
struct TfFwdLayout {
  uint32_t kraw, klo, vraw, vthi, vtlo, wg, bars, total;
};

__host__ __device__ inline TfFwdLayout tf_fwd_layout(int nbq, int bk, int kc,
                                                     int vc, int nst,
                                                     int nwg) {
  TfFwdLayout l;
  const uint32_t kslot = (uint32_t)(kc * bk * 128);
  const uint32_t vslot = (uint32_t)(vc * bk * 128);
  l.kraw = (uint32_t)(nbq * WG_ROWS * 128);
  l.klo = l.kraw + nst * kslot;
  l.vraw = l.klo + kslot;
  l.vthi = l.vraw + nst * vslot;
  l.vtlo = l.vthi + vslot;
  l.wg = (nst + 1) * kslot + (nst + 2) * vslot;
  l.bars = l.kraw + nwg * l.wg;
  l.total = l.bars + 8 * (1 + 2 * nst * nwg);
  return l;
}

// The live keys of tile `it` (BK keys) among this thread's accumulator
// columns: bit 2 j + e is column 8 j + 2 t + e.
template <int BK>
__device__ __forceinline__ uint32_t live_bits(const unsigned char* mb, int it,
                                              int Tk, int t) {
  if (mb == nullptr && (it + 1) * BK <= Tk) return ~0u;
  uint32_t live = 0;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = it * BK + 8 * j + 2 * t + e;
      if (key < Tk && (mb == nullptr || mb[key])) live |= 1u << (2 * j + e);
    }
  return live;
}

// NWG warpgroups of a block split the key tiles (warpgroup w takes tiles
// w, w + NWG, ...), each with its own online-softmax state, O and TMA
// rings, and share the resident Q; at the end the first merges the
// others' (m, l, O) into its own, in a fixed order.
template <int BK, int NOB, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1) flash_fwd_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const unsigned char* __restrict__ mask, float* __restrict__ out,
    float* __restrict__ lse, int H, int Tq, int Tk, int D, int cb, int kc,
    int vc, int nst, float scale) {
  constexpr int NS = BK / 2;  // S accumulator floats a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbox = f32_boxes(D);
  const int nks = (nbox + kc - 1) / kc, nbq = nks * kc;
  const TfFwdLayout L = tf_fwd_layout(nbq, BK, kc, vc, nst, NWG);
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte bases
  const uint32_t kslot = (uint32_t)(kc * BK * 128);
  const uint32_t vslot = (uint32_t)(vc * BK * 128);
  const int bh = blockIdx.x, q0 = blockIdx.y * WG_ROWS;
  const int ob0 = blockIdx.z * cb, nob = min(cb, nbox - ob0);
  const int nvs = (nob + vc - 1) / vc;  // V steps a tile
  const int ntiles = (Tk + BK - 1) / BK;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across the warp (a wgmma under a branch it cannot prove uniform
  // is serialized)
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int ct = threadIdx.x & 127, lane = ct & 31, warp = ct >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mytiles = (ntiles - wg + NWG - 1) / NWG;  // tiles wg, wg + NWG..
  const int nk_steps = mytiles * nks, nv_steps = mytiles * nvs;
  const uint32_t my = base + wg * L.wg;  // this warpgroup's buffers - kraw
  // K full x nst, then V full x nst, of this warpgroup
  const uint32_t bar_q = base + L.bars, bar = bar_q + 8 + 16 * nst * wg;
  const uint32_t vbar = bar + 8 * nst;

  // thread 0 of the warpgroup issues its copies: K step s (its tile s / nks,
  // boxes of chunk s % nks) into K slot s % nst; V step s likewise
  auto load_k = [&](int s) {
    const int it = wg + NWG * (s / nks), c = s % nks;
    const uint32_t full = bar + 8 * (s % nst);
    const uint32_t dst = my + L.kraw + (s % nst) * kslot;
    mbar_expect_tx(full, kslot);
    for (int b = 0; b < kc; ++b)
      tma_load(dst + b * BK * 128, &tm_k, full, (c * kc + b) * F32_BOX,
               it * BK, bh);
  };
  auto load_v = [&](int s) {
    const int it = wg + NWG * (s / nvs), c = s % nvs;
    const uint32_t full = vbar + 8 * (s % nst);
    const uint32_t dst = my + L.vraw + (s % nst) * vslot;
    mbar_expect_tx(full, vslot);
    for (int b = 0; b < vc; ++b)
      tma_load(dst + b * BK * 128, &tm_v, full,
               (ob0 + c * vc + b) * F32_BOX, it * BK, bh);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * nst * NWG; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, (uint32_t)(nbq * WG_ROWS * 128));
    for (int b = 0; b < nbq; ++b)
      tma_load(base + b * WG_ROWS * 128, &tm_q, bar_q, b * F32_BOX, q0, bh);
  }
  if (ct == 0) {
    for (int s = 0; s < nst && s < nk_steps; ++s) load_k(s);
    for (int s = 0; s < nst && s < nv_steps; ++s) load_v(s);
  }

  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const float scale2 = scale * LOG2E;
  float o[NOB][16];
#pragma unroll
  for (int n = 0; n < NOB; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) o[n][i] = 0.f;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};  // rows g, g + 8
  uint32_t ph[BK / 8][4], pl[BK / 8][4];

  mbar_wait(bar_q, 0);
  for (int i = 0; i < mytiles; ++i) {
    const int it = wg + NWG * i;
    float sc[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = 0.f;
    for (int c = 0; c < nks; ++c) {
      const int s = i * nks + c;
      const uint32_t kr = my + L.kraw + (s % nst) * kslot;
      mbar_wait(bar + 8 * (s % nst), (s / nst) & 1);
      lo_tile(my + L.klo, kr, kslot, ct);
      fence_proxy_async();
      wg_sync(wg);
      issue_abt(sc, base + c * kc * WG_ROWS * 128, kr, my + L.klo, kc, BK,
                warp, g, t);
      wg_sync(wg);  // the slot and the lo tile are read
      if (ct == 0 && s + nst < nk_steps) load_k(s + nst);
    }

    float m_new[2], sum[2], alpha[2];
    softmax_tile(sc, live_bits<BK>(mb, it, Tk, t), scale2, m_r, m_new, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_r[r] - m_new[r]);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
      m_r[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < NOB; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) o[n][j] *= alpha[(j >> 1) & 1];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) acc_to_a(sc, j, ph[j], pl[j]);

    for (int c = 0; c < nvs; ++c) {
      const int s = i * nvs + c;
      const uint32_t vr = my + L.vraw + (s % nst) * vslot;
      mbar_wait(vbar + 8 * (s % nst), (s / nst) & 1);
      transpose_tile(my + L.vthi, my + L.vtlo, vr, BK, vc, ct);
      fence_proxy_async();
      wg_sync(wg);
      if (ct == 0 && s + nst < nv_steps) load_v(s + nst);  // the slot is read
#pragma unroll
      for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
      fence_a(ph);
      fence_a(pl);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < NOB; ++n) {
        const int b = n - c * vc;  // this step's box b of the chunk's n
        if (b >= 0 && b < vc && n < nob) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const uint32_t off =
                (uint32_t)((((j >> 2) * vc) + b) * 4096 + (j & 3) * 32);
            wgmma_3x(o[n], ph[j], pl[j], sw128_desc(my + L.vthi + off),
                     sw128_desc(my + L.vtlo + off));
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < NOB; ++n) fence_regs(o[n]);
      fence_a(ph);
      fence_a(pl);
      wg_sync(wg);  // Vt is read: the next step may rewrite it
    }
  }

  if (NWG > 1) {
    // the other warpgroups' (m, l, O), thread by thread (the same rows and
    // columns in every warpgroup), through their own buffers, which every
    // warpgroup is done with after the block barrier
    __syncthreads();
    constexpr int NV = 4 + 16 * NOB;
    float* xs = reinterpret_cast<float*>(smem_raw + L.kraw);
    if (wg > 0) {
      float* mine = xs + (size_t)(wg - 1) * NV * 128;
      mine[0 * 128 + ct] = m_r[0];
      mine[1 * 128 + ct] = m_r[1];
      mine[2 * 128 + ct] = l_r[0];
      mine[3 * 128 + ct] = l_r[1];
#pragma unroll
      for (int n = 0; n < NOB; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mine[(4 + 16 * n + j) * 128 + ct] = o[n][j];
    }
    __syncthreads();
    if (wg > 0) return;
    for (int w = 1; w < NWG; ++w) {
      const float* other = xs + (size_t)(w - 1) * NV * 128;
      float a_me[2], a_ot[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_ot = other[r * 128 + ct];
        const float m = fmaxf(m_r[r], m_ot);
        a_me[r] = exp2f(m_r[r] - m);
        a_ot[r] = exp2f(m_ot - m);
        l_r[r] = l_r[r] * a_me[r] + other[(2 + r) * 128 + ct] * a_ot[r];
        m_r[r] = m;
      }
#pragma unroll
      for (int n = 0; n < NOB; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          o[n][j] = o[n][j] * a_me[(j >> 1) & 1] +
                    other[(4 + 16 * n + j) * 128 + ct] * a_ot[(j >> 1) & 1];
    }
  }

  float* ob = out + (size_t)bh * Tq * D;
  const int row = q0 + 16 * warp + g;
  const float l_div[2] = {fmaxf(l_r[0], 1e-30f), fmaxf(l_r[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < NOB; ++n)
    if (n < nob) {
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = (ob0 + n) * F32_BOX + 8 * (i >> 2) + 2 * t;
        if (row + 8 * r < Tq && col < D)
          *reinterpret_cast<float2*>(ob + (size_t)(row + 8 * r) * D + col) =
              make_float2(o[n][i] / l_div[r], o[n][i + 1] / l_div[r]);
      }
    }
  // lse = m + log(l) in natural units; a fully masked row keeps the JAX
  // kernel's m = -1e30 exactly (its log2-unit maximum never left -1e30)
  if (blockIdx.z == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < Tq)
        lse[(size_t)bh * Tq + row + 8 * r] =
            (m_r[r] <= -1e30f ? -1e30f : m_r[r] * LN2) + logf(l_div[r]);
  }
}

using TfFwdKernel = void (*)(const CUtensorMap, const CUtensorMap,
                             const CUtensorMap, const unsigned char*, float*,
                             float*, int, int, int, int, int, int, int, int,
                             float);

// D <= 64 (64-key tiles, 2 boxes of O), D <= 128 (32-key tiles, 4 boxes),
// D <= 256 (32-key tiles, 8 boxes), D <= 512 (the same, two warpgroups)
constexpr TfFwdKernel TF_KERNELS[] = {
    flash_fwd_tf32_kernel<64, 2, 1>, flash_fwd_tf32_kernel<32, 4, 1>,
    flash_fwd_tf32_kernel<32, 8, 1>, flash_fwd_tf32_kernel<32, 8, 2>};
constexpr int TF_NWG[] = {1, 1, 1, 2};

struct TfPlan {
  int idx, bk, nob, nwg, cb, nz, kc, vc, nst;
  dim3 grid;
  size_t smem;
};

// The plan of a call on the TF32 route: the instantiation (two warpgroups
// splitting the key tiles above D = 128), the boxes a block owns (cb) and
// z-chunks, then the largest steps (kc, vc): two blocks an SM up to
// D = 128, one above (Q alone takes 64-128 KB).
bool plan_fwd_tf(TfPlan& p, int B, int H, int Tq, int Tk, int D) {
  if (!tf32_route(Tq, Tk, D)) return false;
  const int nbox = f32_boxes(D);
  p.idx = nbox <= 2 ? 0 : nbox <= 4 ? 1 : 3;
  p.bk = p.idx == 0 ? 64 : 32;
  p.nob = p.idx == 0 ? 2 : p.idx == 1 ? 4 : 8;
  p.nwg = TF_NWG[p.idx];
  const long rows = (long)B * H * ((Tq + WG_ROWS - 1) / WG_ROWS);
  p.nz = (nbox + p.nob - 1) / p.nob;
  p.cb = (nbox + p.nz - 1) / p.nz;
  while (p.cb > 1 && rows * 2 * p.nz <= sm_count()) {
    p.nz *= 2;
    p.cb = (nbox + p.nz - 1) / p.nz;
  }
  p.nz = (nbox + p.cb - 1) / p.cb;
  // the largest steps first (every step costs two barriers and a drain of
  // the wgmma pipeline), then a third ring slot where it fits
  const size_t limit = nbox > 4 ? 227 * 1024 : 113 * 1024;
  p.kc = p.vc = 1;
  p.nst = 2;
  bool found = false;
  for (int kc : {4, 2, 1})
    for (int vc : {2, 1})
      for (int nst : {3, 2})
        if (!found && kc <= nbox && vc <= p.cb &&
            tf_fwd_layout((nbox + kc - 1) / kc * kc, p.bk, kc, vc, nst, p.nwg)
                    .total <= limit) {
          p.kc = kc;
          p.vc = vc;
          p.nst = nst;
          found = true;
        }
  p.smem = tf_fwd_layout((nbox + p.kc - 1) / p.kc * p.kc, p.bk, p.kc, p.vc,
                         p.nst, p.nwg)
               .total;
  p.grid = dim3(B * H, (Tq + WG_ROWS - 1) / WG_ROWS, p.nz);
  return true;
}

cudaError_t prepare_tf(int idx, size_t smem) {
  static size_t opted[MAX_DEVICES][4] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  return opt_in(TF_KERNELS[idx], smem, &opted[dev][idx]);
}

}  // namespace

// q: (B,H,Tq,D), k, v: (B,H,Tk,D), out: (B,H,Tq,D), lse: (B*H,Tq) float32,
// all contiguous on the device and 16-byte aligned; mask: (B,Tk) bool bytes
// (1 = attend) or null. D is a multiple of 8 and at most 1024. Launches on
// `stream` and returns the launch's error code (0 = launched).
extern "C" int t2p_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, void* lse, int B,
                                 int H, int Tq, int Tk, int D, float scale,
                                 void* stream) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TfPlan w{};
  if (plan_fwd_tf(w, B, H, Tq, Tk, D)) {
    CUtensorMap mq, mk, mv;
    if (!tensor_map(&mq, q, B * H, Tq, D, WG_ROWS, F32_BOX, 4) ||
        !tensor_map(&mk, k, B * H, Tk, D, w.bk, F32_BOX, 4) ||
        !tensor_map(&mv, v, B * H, Tk, D, w.bk, F32_BOX, 4))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare_tf(w.idx, w.smem);
    if (err != cudaSuccess) return (int)err;
    TF_KERNELS[w.idx]<<<w.grid, 128 * w.nwg, w.smem, s>>>(
        mq, mk, mv, static_cast<const unsigned char*>(mask),
        static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, D,
        w.cb, w.kc, w.vc, w.nst, scale);
    return (int)cudaGetLastError();
  }
  const FwdPlan p = plan_fwd(B, H, Tq, Tk, D);
  const int idx = kernel_index(p);
  cudaError_t err = prepare(idx, p.smem);
  if (err != cudaSuccess) return (int)err;
  KERNELS[idx]<<<p.grid, NT, p.smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, D, p.dc,
      p.bk, p.stages, scale);
  return (int)cudaGetLastError();
}

// The launch plan of a call, for reports: out = {key tile rows, pipeline
// stages, column chunks (blocks of a row tile, each computing S), blocks,
// dynamic shared bytes, blocks per SM, threads per block, narrow (D <= 64,
// 64-key tiles), wgmma (1: TF32 wgmma; 0: the mma.sync kernel of D > 512),
// K boxes a step, blocks of a cluster (1), clusters held at once (-1: no
// cluster)}.
extern "C" int t2p_flash_fwd_plan(int B, int H, int Tq, int Tk, int D,
                                  int* out) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  TfPlan w{};
  int per_sm = -1;
  if (plan_fwd_tf(w, B, H, Tq, Tk, D)) {
    if (prepare_tf(w.idx, w.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, TF_KERNELS[w.idx], 128 * w.nwg, w.smem) != cudaSuccess)
      per_sm = -1;
    const int v[12] = {w.bk, w.nst, w.nz,
                       (int)(w.grid.x * w.grid.y * w.grid.z),
                       (int)w.smem, per_sm, 128 * w.nwg, w.idx == 0, 1, w.kc,
                       1, -1};
    for (int i = 0; i < 12; ++i) out[i] = v[i];
    return 0;
  }
  const FwdPlan p = plan_fwd(B, H, Tq, Tk, D);
  const int idx = kernel_index(p);
  if (prepare(idx, p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, KERNELS[idx], NT, p.smem) != cudaSuccess)
    per_sm = -1;
  const int v[12] = {p.bk, p.stages, p.nchunk,
                     (int)(p.grid.x * p.grid.y * p.grid.z), (int)p.smem,
                     per_sm, NT, 0, 0, 0, 1, -1};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
