// Flash-attention forward for Hopper (sm_90a), float32 in and out.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// text2protein_tpu/ops/flash.py (reached through `flash_attention_fwd`).
// Same function: blockwise online-softmax attention over q (B,H,Tq,D) and
// k, v (B,H,Tk,D) with an optional (B,Tk) key mask applied as a -1e30 bias
// and p *= mask, so a fully masked row gives 0; accumulation in f32,
// out /= max(l, 1e-30), and lse = m + log(max(l, 1e-30)) per row.
//
// What bounds it on the card: at the L=128 serving shapes (B=4, T <= 256,
// H*D = 256) one call moves at most 4.2 MB (1.3 us at 3.35 TB/s) and does
// at most 2.7e8 FLOPs: 4.0 us at the f32 CUDA-core rate (67 TFLOP/s), or
// 1.6 us as 3xTF32 on the tensor cores (3 x 2.7e8 at 495 TFLOP/s). So the
// least time is a few microseconds, below the launch latency and the
// wrapper's host time, and what decides the kernel's time is how much of
// the card it keeps busy. The first version of this kernel (CUDA-core FMA
// chains on shared memory, 64 blocks at the AttnBlock shape) took 142.3 us
// there against SDPA's 40.0 us.
//
// Design. Two kernels, chosen per call by plan_fwd:
//   * Tensor cores at f32 accuracy in both: Q K^T and P V are m16n8k8 TF32
//     `mma.sync` products in 3xTF32 form (mma_tf32x3.cuh). The scale and
//     the -1e30 mask bias are applied to the f32 accumulator afterwards.
//     cp.async double-buffers the k/v tiles (tile i+1 is in flight while
//     tile i is multiplied), and the mask is read as the bool bytes it is.
//   * Narrow (D <= 64; the self- and cross-attention shapes, D = 32): each
//     warp owns 16 query rows (FA2's layout) and computes its S slab
//     (16 x 64 keys) over all of D, the online softmax (m, l per row) and
//     O (16 x D) in registers; P reaches its own P V product through a slab
//     of shared memory only it touches. Up to 4 warps (64 rows) share each
//     k/v tile: two block barriers per tile.
//   * Wide (D > 64; the AttnBlock shapes, D = 256): a block of 8 warps owns
//     16 query rows and, where the grid would otherwise hold fewer than two
//     blocks per SM, one chunk of >= 64 of the D output columns (grid z):
//     the AttnBlock shape (B*H = 4, Tq = 256) runs 4 x 16 x 4 = 256 blocks
//     instead of 64, each recomputing the scores of its rows. For S over a
//     key tile of BK keys each warp computes a 16 x 16 slab over a share of
//     D (each A fragment split once for two products; the partial sums meet
//     in shared memory); the warp owning a row keeps its (m, l) in
//     registers and passes alpha and P through shared memory; for
//     O += P V the warps split the output columns, O in registers.
//   * Shared memory and tiles: two blocks per SM where it fits (the wide
//     kernel at D = 256: 112 KB, BK = 32), three for the narrow one.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py, PERF.md section 6):
// ptxas reports no spills and no stack frame in any instantiation (narrow
// <4> at D = 32: 104 registers; wide <1>: 95). Per launch at B = 4 the
// self 16x16 shape takes ~31 us (SDPA ~28 us) and the AttnBlock 16x16
// ~56 us (SDPA ~40 us): the wide kernel's 16-row blocks are latency-bound
// (8 key tiles x 4 barriers per block) and its TF32 splits cost ~4
// instructions per mma. The 4x4 shapes are paced by the wrapper's host
// time (16-24 us a call on that machine's host).

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"

namespace {

using namespace t2p;

constexpr int NARROW_WARPS = 4;  // most warps a block of the narrow kernel

// per-call choices: which kernel, key tile rows, pipeline stages, output
// column chunks, and the launch shape
struct FwdPlan {
  int narrow, bk, stages, nchunk, dc, ntw, threads;
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

// SMs of the current device, cached per device
int sm_count() {
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

FwdPlan plan_fwd(int B, int H, int Tq, int Tk, int D) {
  FwdPlan p{};
  if (D <= 64) {  // the narrow kernel: 16 query rows a warp
    const int warps = min(NARROW_WARPS, (Tq + ROWS - 1) / ROWS);
    p.narrow = 1;
    p.bk = 8;
    while (p.bk < 64 && p.bk < Tk) p.bk *= 2;
    p.stages = 2;
    p.nchunk = 1;
    p.dc = D;
    p.threads = 32 * warps;
    p.grid = dim3(B * H, (Tq + ROWS * warps - 1) / (ROWS * warps), 1);
    p.smem = sizeof(float) * ((size_t)warps * ROWS * pad_ld(D) +
                              (size_t)2 * 2 * p.bk * pad_ld(D) +
                              (size_t)warps * ROWS * pad_ld(p.bk));
    return p;
  }
  p.threads = NT;
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

// The narrow kernel, for D <= 64: each warp owns 16 query rows outright
// (FA2's layout). It computes its S slab (16 x BK) over all of D, keeps the
// online-softmax state and O (16 x D) in registers, and passes P to its own
// P V product through a slab of shared memory that only it touches; the
// warps of a block (up to 4, 64 rows) share the k/v tiles, so a key tile
// costs two block barriers. Same signature as the wide kernel (D, dc and
// stages are fixed by ND and unused).
template <int ND>
__global__ void __launch_bounds__(NARROW_WARPS * 32, 3) flash_fwd_narrow_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    int, int, int bk, int, float scale) {
  constexpr int D = 8 * ND;
  constexpr int ldd = D + 4;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int rows = warps * ROWS;
  const int ldp = pad_ld(bk), nn = bk >> 3;
  const int stage_floats = 2 * bk * ldd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* sq = smem;                          // rows x ldd
  float* stage0 = sq + rows * ldd;           // 2 stages x (k, v tiles)
  float* spw = stage0 + 2 * stage_floats + warp * ROWS * ldp;  // this warp's P

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tk + bk - 1) / bk;

  auto load_kv = [&](int it, int s) {
    float* sk = stage0 + s * stage_floats;
    load_tile_async(sk, ldd, kb, D, it * bk, bk, Tk, 0, D);
    load_tile_async(sk + bk * ldd, ldd, vb, D, it * bk, bk, Tk, 0, D);
  };
  load_tile_async(sq, ldd, qb, D, q0, rows, Tq, 0, D);
  load_kv(0, 0);
  cp_async_commit();

  const float* sqw = sq + warp * ROWS * ldd;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};  // rows g, g + 8
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = stage0 + (it & 1) * stage_floats;
    const float* sv = sk + bk * ldd;

    float sc[8][4];  // S (16 x bk <= 64) as 8 accumulator fragments
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      float fa[4];
      load_a(fa, sqw, ldd, kk * 8, lane);
      const SplitA a = split_a(fa);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n < nn) {
          float fb[2];
          load_bt(fb, sk, ldd, n * 8, kk * 8, lane);
          mma_3xtf32(sc[n], a, fb);
        }
    }

    // scale and mask bias, then the online softmax of rows g and g + 8
    const int k0 = it * bk;
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const bool live = n < nn && key < Tk && (mb == nullptr || mb[key]);
        sc[n][i] = sc[n][i] * scale + (live ? 0.f : -1e30f);
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const bool live = n < nn && key < Tk && (mb == nullptr || mb[key]);
        const float p = live ? expf(sc[n][i] - m_new[i >> 1]) : 0.f;
        sc[n][i] = p;
        sum[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha[r] = expf(m_r[r] - m_new[r]);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
      m_r[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P through this warp's slab of shared memory
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (n < nn) store_c(spw, ldp, n * 8, sc[n], lane);
    __syncwarp();
    for (int kk = 0; kk < bk; kk += 8) {
      float fa[4];
      load_a(fa, spw, ldp, kk, lane);
      const SplitA a = split_a(fa);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float fb[2];
        load_bn(fb, sv, ldd, n * 8, kk, lane);
        mma_3xtf32(o[n], a, fb);
      }
    }
    __syncthreads();  // the stage is read; the next prefetch may refill it
  }

  float* ob = out + (size_t)bh * Tq * D;
  const int row = q0 + warp * ROWS + g;
  const float l_top = fmaxf(l_r[0], 1e-30f), l_bot = fmaxf(l_r[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (row < Tq)
      *reinterpret_cast<float2*>(ob + (size_t)row * D + col) =
          make_float2(o[n][0] / l_top, o[n][1] / l_top);
    if (row + 8 < Tq)
      *reinterpret_cast<float2*>(ob + (size_t)(row + 8) * D + col) =
          make_float2(o[n][2] / l_bot, o[n][3] / l_bot);
  }
  if (t == 0) {
    if (row < Tq) lse[(size_t)bh * Tq + row] = m_r[0] + logf(l_top);
    if (row + 8 < Tq) lse[(size_t)bh * Tq + row + 8] = m_r[1] + logf(l_bot);
  }
}

using FwdKernel = void (*)(const float*, const float*, const float*,
                           const unsigned char*, float*, float*, int, int,
                           int, int, int, int, int, float);

// every instantiation: the wide kernel for NTW = 1, 2, 4, 8, 16, then the
// narrow one for D = 8, 16, ..., 64
constexpr FwdKernel KERNELS[] = {
    flash_fwd_kernel<1>,        flash_fwd_kernel<2>,
    flash_fwd_kernel<4>,        flash_fwd_kernel<8>,
    flash_fwd_kernel<16>,       flash_fwd_narrow_kernel<1>,
    flash_fwd_narrow_kernel<2>, flash_fwd_narrow_kernel<3>,
    flash_fwd_narrow_kernel<4>, flash_fwd_narrow_kernel<5>,
    flash_fwd_narrow_kernel<6>, flash_fwd_narrow_kernel<7>,
    flash_fwd_narrow_kernel<8>};
constexpr int NKERNELS = sizeof(KERNELS) / sizeof(KERNELS[0]);

// index into KERNELS of a plan
int kernel_index(const FwdPlan& p, int D) {
  if (p.narrow) return 5 + D / 8 - 1;
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
  const FwdPlan p = plan_fwd(B, H, Tq, Tk, D);
  const int idx = kernel_index(p, D);
  cudaError_t err = prepare(idx, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KERNELS[idx]<<<p.grid, p.threads, p.smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), H, Tq, Tk, D, p.dc,
      p.bk, p.stages, scale);
  return (int)cudaGetLastError();
}

// The launch plan of a call, for reports: out = {key tile rows, pipeline
// stages, column chunks, blocks, dynamic shared bytes, blocks per SM,
// threads per block, narrow (1) or wide (0) kernel}.
extern "C" int t2p_flash_fwd_plan(int B, int H, int Tq, int Tk, int D,
                                  int* out) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  const FwdPlan p = plan_fwd(B, H, Tq, Tk, D);
  const int idx = kernel_index(p, D);
  int per_sm = -1;
  if (prepare(idx, p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, KERNELS[idx], p.threads, p.smem) != cudaSuccess)
    per_sm = -1;
  out[0] = p.bk;
  out[1] = p.stages;
  out[2] = p.nchunk;
  out[3] = (int)(p.grid.x * p.grid.y * p.grid.z);
  out[4] = (int)p.smem;
  out[5] = per_sm;
  out[6] = p.threads;
  out[7] = p.narrow;
  return 0;
}

// ------------------------------------------------------------------ bf16
//
// The same function on bf16 q, k, v (the TPU kernel upcasts them to f32 and
// writes `out` in the input's dtype, `lse` in f32): S = Q K^T and the
// online softmax in f32, O = P V accumulated in f32, out rounded to bf16
// once, lse f32.
//
// What bounds it on the card: at the N=256 serving shapes (B=4, T <= 1024,
// H*D = 512) one call moves at most 16.8 MB of bf16 (5.0 us at 3.35 TB/s)
// and does at most 4 B H Tq Tk D = 8.6 GFLOP, 8.7 us at the bf16 tensor-core
// rate (989 TFLOP/s); the split P V issues a third more mma work than that.
//
// Design (mma_bf16.cuh): `mma.sync.m16n8k16`, bf16 operands, f32
// accumulators. Q K^T is one exact mma per fragment pair; P stays in the
// registers it was computed in and enters P V as a hi + lo pair of bf16
// A fragments (two mmas), V's B fragments come from `ldmatrix .trans`.
// Each warp owns 16 query rows (up to 4 warps a block share each k/v
// tile, cp.async double-buffered). A block owns one chunk of the output
// columns (grid z): all of D up to 64 (the self- and cross-attention
// shapes, D = 64), chunks of 128 above (the AttnBlock shapes, D = 512),
// where each chunk recomputes S over all of D. The scale and the -1e30 mask
// bias go on the f32 accumulator; p *= mask as in the f32 kernel.

namespace {

using namespace t2p;

// Shared bytes: q rows, then two stages of (k tile, v tile).
size_t fwd16_smem(int D, int dc, int warps, int bk) {
  const int ldq = pad_ld16(round16(D)), ldv = pad_ld16(dc);
  return sizeof(bf16) *
         ((size_t)warps * ROWS * ldq + (size_t)2 * bk * (ldq + ldv));
}

bool plan_fwd16(Bf16Plan& p, int B, int H, int Tq, int Tk, int D) {
  p.dc = D <= 64 ? D : 128;
  p.nchunk = (D + p.dc - 1) / p.dc;
  p.idx = D <= 64 ? 0 : 1;
  return plan_bf16(p, B * H, Tq, Tk, 64, [&](int warps, int bk) {
    return fwd16_smem(D, p.dc, warps, bk);
  });
}

// NO: 8-column tiles of O a warp holds (the chunk's dc <= 8 NO columns).
template <int NO>
__global__ void __launch_bounds__(4 * 32) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    bf16* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    int D, int dc, int bk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int D16 = round16(D);
  const int ldq = pad_ld16(D16), ldv = pad_ld16(dc);
  const int rows = (blockDim.x >> 5) * ROWS;
  const int nn = bk >> 3;
  const int stage = bk * (ldq + ldv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* sq = smem;                 // rows x ldq
  bf16* stage0 = sq + rows * ldq;  // 2 stages x (k tile, v tile)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int c0 = blockIdx.z * dc;
  const int cols = min(dc, D - c0);
  const bf16* qb = q + (size_t)bh * Tq * D;
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tk + bk - 1) / bk;

  if (D16 != D) {
    zero_pad16(sq, ldq, rows, D);
    zero_pad16(stage0, ldq, bk, D);
    zero_pad16(stage0 + stage, ldq, bk, D);
  }
  auto load_kv = [&](int it, int s) {
    bf16* sk = stage0 + s * stage;
    load_tile_async16(sk, ldq, kb, D, it * bk, bk, Tk, 0, D);
    load_tile_async16(sk + bk * ldq, ldv, vb, D, it * bk, bk, Tk, c0, cols);
  };
  load_tile_async16(sq, ldq, qb, D, q0, rows, Tq, 0, D);
  load_kv(0, 0);
  cp_async_commit();

  const bf16* sqw = sq + warp * ROWS * ldq;
  float m_r[2] = {-1e30f, -1e30f}, l_r[2] = {0.f, 0.f};  // rows g, g + 8
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_kv(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = stage0 + (it & 1) * stage;
    const bf16* sv = sk + bk * ldq;

    float sc[8][4];  // S (16 x bk <= 64) as 8 accumulator fragments
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    for (int kk = 0; kk < D16; kk += 16) {
      uint32_t a[4];
      load_a16(a, sqw, ldq, kk, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (n < nn) {
          uint32_t b[2];
          load_bt16(b, sk, ldq, n * 8, kk, lane);
          mma_bf16(sc[n], a, b);
        }
    }

    // scale and mask bias, then the online softmax of rows g and g + 8
    const int k0 = it * bk;
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const bool live = n < nn && key < Tk && (mb == nullptr || mb[key]);
        sc[n][i] = sc[n][i] * scale + (live ? 0.f : -1e30f);
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_r[r], mx[r]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const bool live = n < nn && key < Tk && (mb == nullptr || mb[key]);
        const float p = live ? expf(sc[n][i] - m_new[i >> 1]) : 0.f;
        sc[n][i] = p;
        sum[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha[r] = expf(m_r[r] - m_new[r]);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
      m_r[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P from registers as hi + lo bf16 A fragments
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (2 * j < nn) {
        const SplitA16 pa = split_c_to_a(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          if (n * 8 < cols) {
            uint32_t b[2];
            load_bn16(b, sv, ldv, n * 8, j * 16, lane);
            mma_split(o[n], pa, b);
          }
      }
    __syncthreads();  // the stage is read; the next prefetch may refill it
  }

  bf16* ob = out + (size_t)bh * Tq * D;
  const int row = q0 + warp * ROWS + g;
  const float l_top = fmaxf(l_r[0], 1e-30f), l_bot = fmaxf(l_r[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < NO; ++n)
    if (n * 8 < cols) {
      const int col = c0 + n * 8 + 2 * t;
      if (row < Tq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + col) =
            pack_bf16(o[n][0] / l_top, o[n][1] / l_top);
      if (row + 8 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(row + 8) * D + col) =
            pack_bf16(o[n][2] / l_bot, o[n][3] / l_bot);
    }
  if (blockIdx.z == 0 && t == 0) {
    if (row < Tq) lse[(size_t)bh * Tq + row] = m_r[0] + logf(l_top);
    if (row + 8 < Tq) lse[(size_t)bh * Tq + row + 8] = m_r[1] + logf(l_bot);
  }
}

using Fwd16Kernel = void (*)(const bf16*, const bf16*, const bf16*,
                             const unsigned char*, bf16*, float*, int, int,
                             int, int, int, int, float);

// D <= 64 (one chunk of D columns), then D > 64 (chunks of 128)
constexpr Fwd16Kernel KERNELS16[] = {flash_fwd_bf16_kernel<8>,
                                     flash_fwd_bf16_kernel<16>};
constexpr int NKERNELS16 = sizeof(KERNELS16) / sizeof(KERNELS16[0]);

cudaError_t prepare16(int idx, size_t smem) {
  static size_t opted[MAX_DEVICES][NKERNELS16] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  return opt_in(KERNELS16[idx], smem, &opted[dev][idx]);
}

}  // namespace

// As t2p_flash_fwd_f32, with q, k, v and out bf16 (lse stays float32).
extern "C" int t2p_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  const void* mask, void* out, void* lse,
                                  int B, int H, int Tq, int Tk, int D,
                                  float scale, void* stream) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
  Bf16Plan p{};
  if (!plan_fwd16(p, B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare16(p.idx, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KERNELS16[p.idx]<<<p.grid, 32 * p.warps, p.smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(mask),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Tq, Tk, D, p.dc,
      p.t, scale);
  return (int)cudaGetLastError();
}

// The bf16 kernel's launch plan, in t2p_flash_fwd_plan's layout (stages is
// always 2; "narrow" = one chunk of all D columns).
extern "C" int t2p_flash_fwd_bf16_plan(int B, int H, int Tq, int Tk, int D,
                                       int* out) {
  Bf16Plan p{};
  if (!valid_shape(B, H, Tq, Tk, D) || !plan_fwd16(p, B, H, Tq, Tk, D))
    return (int)cudaErrorInvalidValue;
  int per_sm = -1;
  if (prepare16(p.idx, p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, KERNELS16[p.idx], 32 * p.warps, p.smem) != cudaSuccess)
    per_sm = -1;
  out[0] = p.t;
  out[1] = 2;
  out[2] = p.nchunk;
  out[3] = (int)(p.grid.x * p.grid.y * p.grid.z);
  out[4] = (int)p.smem;
  out[5] = per_sm;
  out[6] = 32 * p.warps;
  out[7] = p.nchunk == 1;
  return 0;
}
