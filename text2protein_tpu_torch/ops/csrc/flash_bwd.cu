// Flash-attention backward for Hopper (sm_90a), float32 in and out.
//
// Replaces the Pallas TPU kernel `_flash_bwd_kernel` of
// text2protein_tpu/ops/flash.py:168 (reached through `flash_attention_bwd`).
// Same function, per batch*head, from the forward's residuals (out, lse):
//   S  = (q k^T) * scale + (mask - 1) * 1e30     (bias BEFORE the exp)
//   P  = exp(S - lse)                             (no P *= mask afterwards)
//   dV = P^T dO
//   dS = P * (dO v^T - delta) * scale,  delta = rowsum(dO * out)
//   dQ = dS k,   dK = dS^T q
// A fully masked row has lse ~ -1e30 from the forward, so P = exp(0) = 1
// on every key of that row, exactly as in the JAX kernel.
//
// What bounds it on the card: 10 B H Tq Tk D FLOPs (the JAX cost estimate)
// and the bytes of q, k, v, out, dO, lse read and dq, dk, dv written. At
// test_config's AttnBlock 32x32 (B=2, H=1, T=1024, D=512) that is 10.7
// GFLOP and 29 MB: 0.160 ms at the f32 CUDA-core rate, 0.065 ms as 3xTF32
// on the tensor cores (3 x 10.7 GFLOP at 495 TFLOP/s), the bound of this
// kernel's route.
//
// Design. Two kernels tile the (Tq, Tk) block FA2-style, recompute P from
// lse inside each tile, and give every output element one owner, so the
// sums run in a fixed order without atomics: dq (blocks over query rows;
// its prologue writes delta = rowsum(dO * out) for the next kernel) and
// dkdv (blocks over key rows). D <= 512 (every f32 call of the paths but
// test_config_large's D=1024): `flash_bwd_{dq,dkdv}_tf32_kernel` below,
// after the bf16 kernels, on TF32 wgmma in 3xTF32 form (wgmma_tf32.cuh).
// D > 512 keeps `flash_bwd_{dq,dkdv}_kernel` here: m16n8k8 TF32 `mma.sync`
// in 3xTF32 form (mma_tf32x3.cuh), a block of 8 warps on 16 rows and a
// chunk of at most 256 output columns (grid z); for S and dP of a tile each
// warp computes a 16 x 16 slab of one of the two over a share of D, the
// partial sums meet in shared memory, where one pass forms P and dS; for
// the dK/dV/dQ sums the warps split the output columns (dkdv: 4 warps dV,
// 4 warps dK), the sums in registers; cp.async double-buffers the inner
// tiles. At test_config_large's 8x8 calls (D=1024) it took 2.368 ms per
// train step against SDPA's backward 5.711 (chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700 W).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; scripts/flash_ab.py, device
// time by CUDA-graph replay, against the mma.sync kernels these replace and
// SDPA's backward, its forward and backward less its forward): the
// AttnBlock 32x32 of test_config (B=2, D=512) 0.854 ms a call (mma.sync
// 1.592, SDPA 1.082: the route's bound is 0.065), its 8 heads of 64 at
// 32x32 0.385 (0.706, SDPA 0.351); per test_config train step 10.62 ms
// (18.70, SDPA 11.80); per L=128 train step 2.13 ms (2.49, SDPA 2.23).
// ptxas: no spill, no stack frame (up to 255 registers).

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace t2p;

constexpr int DCHUNK = 256;  // most output columns a block owns

// per-call choices of one D > 512 kernel: inner tile rows, pipeline stages,
// column chunks (grid z) of dc columns and the launch shape
struct BwdPlan {
  int t, stages, nchunk, dc;
  dim3 grid;
  size_t smem;
};

size_t bwd_smem(int D, int t, int stages) {
  const int ldd = pad_ld(D), ldp = pad_ld(t);
  const int kpn = NWARP / (2 * (t >= 16 ? t / 16 : 1));
  return sizeof(float) * ((size_t)2 * ROWS * ldd +
                          (size_t)stages * 2 * t * ldd +
                          (size_t)2 * kpn * ROWS * ldp +
                          (size_t)2 * ROWS * ldp + ROWS);
}

// `rows` is the length the grid walks (Tq for dq, Tk for dkdv), `loop` the
// length the block's inner loop walks (Tk for dq, Tq for dkdv). For
// 512 < D <= 1024 the chunks are 3 or 4 of 176-256 columns: 22-32 n-tiles,
// 4 a warp in dq (8 warps) and 8 in dkdv (4 warps a sum): the NTW of
// DQ_KERNEL and DKDV_KERNEL.
BwdPlan plan_bwd(int B, int H, int rows, int loop, int D) {
  BwdPlan p{};
  p.nchunk = (D + DCHUNK - 1) / DCHUNK;
  p.dc = ((D + p.nchunk - 1) / p.nchunk + 7) / 8 * 8;
  p.grid = dim3(B * H, (rows + ROWS - 1) / ROWS, p.nchunk);
  int cap = 8;
  while (cap < 32 && cap < loop) cap *= 2;
  const size_t limits[2] = {113 * 1024, 227 * 1024};
  for (size_t limit : limits)
    for (int t = cap; t >= 8; t /= 2)
      if (bwd_smem(D, t, 2) <= limit) {
        p.t = t;
        p.stages = 2;
        p.smem = bwd_smem(D, t, 2);
        return p;
      }
  p.t = 8;
  p.stages = 1;
  p.smem = bwd_smem(D, 8, 1);
  return p;
}

template <int NTW>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, const unsigned char* __restrict__ mask,
    float* __restrict__ dq, int H, int Tq, int Tk, int D, int dc, int T,
    int stages, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldd = pad_ld(D), ldp = pad_ld(T);
  // phase A: 16 x 16 slabs (16 x 8 where T = 8) of S and of dP
  const int nt = T >> 3, ns = nt >= 2 ? nt / 2 : 1;
  const int nwork = 2 * ns, kpn = NWARP / nwork;
  const int stage_floats = 2 * T * ldd;
  float* sq = smem;                               // 16 x ldd
  float* sdo = sq + ROWS * ldd;                   // 16 x ldd
  float* stage0 = sdo + ROWS * ldd;               // stages x (k, v tiles)
  float* spart = stage0 + stages * stage_floats;  // 2 x kpn x 16 x ldp
  float* sds = spart + 2 * kpn * ROWS * ldp;      // 16 x ldp: dS
  float* sdelta = sds + 2 * ROWS * ldp;           // 16

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int c0 = blockIdx.z * dc;
  const int cols = min(dc, D - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qoff = (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const float* lb = lse + (size_t)bh * Tq;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tk + T - 1) / T;

  auto load_kv = [&](int it, int s) {
    float* sk = stage0 + s * stage_floats;
    load_tile_async(sk, ldd, kb, D, it * T, T, Tk, 0, D);
    load_tile_async(sk + T * ldd, ldd, vb, D, it * T, T, Tk, 0, D);
  };
  load_tile_async(sq, ldd, q + qoff, D, q0, ROWS, Tq, 0, D);
  load_tile_async(sdo, ldd, dout + qoff, D, q0, ROWS, Tq, 0, D);
  load_kv(0, 0);
  cp_async_commit();

  // delta = rowsum(dO * out) of rows 2 * warp + r, while the tiles load
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 2 * warp + r;
    float d = 0.f;
    if (q0 + i < Tq) {
      const float* o = out + qoff + (size_t)(q0 + i) * D;
      const float* g = dout + qoff + (size_t)(q0 + i) * D;
      for (int c = lane; c < D; c += 32) d = fmaf(g[c], o[c], d);
      d = warp_sum(d);
      if (lane == 0 && blockIdx.z == 0) delta[(size_t)bh * Tq + q0 + i] = d;
    }
    if (lane == 0) sdelta[i] = d;
  }

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
    const float* sv = sk + T * ldd;

    {  // one slab of S = q k^T (prod 0) or dP = dO v^T (prod 1)
      const int work = warp % nwork, kp = warp / nwork;
      const int prod = work / ns;
      const float* a = prod ? sdo : sq;
      const float* b = prod ? sv : sk;
      float* part = spart + (prod * kpn + kp) * ROWS * ldp;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      if (nt >= 2) {
        const int n0 = (work % ns) * 16;
        mma_abt2(c0, c1, a, ldd, b, ldd, n0, D, kp, kpn, lane);
        store_c(part, ldp, n0, c0, lane);
        store_c(part, ldp, n0 + 8, c1, lane);
      } else {
        mma_abt(c0, a, ldd, b, ldd, 0, D, kp, kpn, lane);
        store_c(part, ldp, 0, c0, lane);
      }
    }
    __syncthreads();

    const int k0 = it * T;
    for (int e = tid; e < ROWS * T; e += NT) {
      const int i = e / T, j = e - i * T;
      float ds = 0.f;
      if (q0 + i < Tq && k0 + j < Tk) {
        float s = 0.f, dp = 0.f;
        for (int kp = 0; kp < kpn; ++kp) {
          s += spart[(kp * ROWS + i) * ldp + j];
          dp += spart[((kpn + kp) * ROWS + i) * ldp + j];
        }
        const float bias = (mb && !mb[k0 + j]) ? -1e30f : 0.f;
        s = s * scale + bias;
        const float p = expf(s - lb[q0 + i]);
        ds = p * (dp - sdelta[i]) * scale;
      }
      sds[i * ldp + j] = ds;
    }
    __syncthreads();

    // dQ (16 x cols) += dS k[:, c0:c0+cols], the warps splitting the columns
    for (int kk = 0; kk < T; kk += 8) {
      float fa[4];
      load_a(fa, sds, ldp, kk, lane);
      const SplitA a = split_a(fa);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int n0 = (warp + n * NWARP) * 8;
        if (n0 < cols) {
          float fb[2];
          load_bn(fb, sk, ldd, c0 + n0, kk, lane);
          mma_3xtf32(acc[n], a, fb);
        }
      }
    }
    __syncthreads();
    if (stages == 1 && it + 1 < ntiles) {
      load_kv(it + 1, 0);
      cp_async_commit();
    }
  }

  const int g = lane >> 2, t = lane & 3;
  float* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int n0 = (warp + n * NWARP) * 8;
    if (n0 < cols) {
      const int col = c0 + n0 + 2 * t;
      if (q0 + g < Tq)
        *reinterpret_cast<float2*>(dqb + (size_t)(q0 + g) * D + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (q0 + g + 8 < Tq)
        *reinterpret_cast<float2*>(dqb + (size_t)(q0 + g + 8) * D + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

template <int NTW>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ mask, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Tq, int Tk, int D, int dc, int T,
    int stages, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldd = pad_ld(D), ldp = pad_ld(T);
  // phase A: 16 x 16 slabs (16 x 8 where T = 8) of S and of dP
  const int nt = T >> 3, ns = nt >= 2 ? nt / 2 : 1;
  const int nwork = 2 * ns, kpn = NWARP / nwork;
  const int stage_floats = 2 * T * ldd;
  float* sk = smem;                               // 16 x ldd
  float* sv = sk + ROWS * ldd;                    // 16 x ldd
  float* stage0 = sv + ROWS * ldd;                // stages x (q, dO tiles)
  float* spart = stage0 + stages * stage_floats;  // 2 x kpn x 16 x ldp
  float* spt = spart + 2 * kpn * ROWS * ldp;      // 16 x ldp: P^T
  float* sdst = spt + ROWS * ldp;                 // 16 x ldp: dS^T

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;
  const int c0 = blockIdx.z * dc;
  const int cols = min(dc, D - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t koff = (size_t)bh * Tk * D;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* dob = dout + (size_t)bh * Tq * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tq + T - 1) / T;

  auto load_qdo = [&](int it, int s) {
    float* sq = stage0 + s * stage_floats;
    load_tile_async(sq, ldd, qb, D, it * T, T, Tq, 0, D);
    load_tile_async(sq + T * ldd, ldd, dob, D, it * T, T, Tq, 0, D);
  };
  load_tile_async(sk, ldd, k + koff, D, k0, ROWS, Tk, 0, D);
  load_tile_async(sv, ldd, v + koff, D, k0, ROWS, Tk, 0, D);
  load_qdo(0, 0);
  cp_async_commit();

  // warps 0-3 sum dV = P^T dO, warps 4-7 dK = dS^T q
  const int half = warp >> 2, w4 = warp & 3;
  float acc[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = stages == 2 ? (it & 1) : 0;
    if (stages == 2 && it + 1 < ntiles) {
      load_qdo(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sq = stage0 + st * stage_floats;
    const float* sdo = sq + T * ldd;

    {  // one slab of S^T = k q^T (prod 0) or dP^T = v dO^T (prod 1)
      const int work = warp % nwork, kp = warp / nwork;
      const int prod = work / ns;
      const float* a = prod ? sv : sk;
      const float* b = prod ? sdo : sq;
      float* part = spart + (prod * kpn + kp) * ROWS * ldp;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      if (nt >= 2) {
        const int n0 = (work % ns) * 16;
        mma_abt2(c0, c1, a, ldd, b, ldd, n0, D, kp, kpn, lane);
        store_c(part, ldp, n0, c0, lane);
        store_c(part, ldp, n0 + 8, c1, lane);
      } else {
        mma_abt(c0, a, ldd, b, ldd, 0, D, kp, kpn, lane);
        store_c(part, ldp, 0, c0, lane);
      }
    }
    __syncthreads();

    const int q0 = it * T;
    for (int e = tid; e < ROWS * T; e += NT) {
      const int i = e / T, j = e - i * T;  // key i, query j
      float p = 0.f, ds = 0.f;
      if (k0 + i < Tk && q0 + j < Tq) {
        float s = 0.f, dp = 0.f;
        for (int kp = 0; kp < kpn; ++kp) {
          s += spart[(kp * ROWS + i) * ldp + j];
          dp += spart[((kpn + kp) * ROWS + i) * ldp + j];
        }
        const float bias = (mb && !mb[k0 + i]) ? -1e30f : 0.f;
        s = s * scale + bias;
        p = expf(s - lb[q0 + j]);
        ds = p * (dp - db[q0 + j]) * scale;
      }
      spt[i * ldp + j] = p;
      sdst[i * ldp + j] = ds;
    }
    __syncthreads();

    {  // dV += P^T dO (warps 0-3), dK += dS^T q (warps 4-7)
      const float* a_src = half ? sdst : spt;
      const float* b_src = half ? sq : sdo;
      for (int kk = 0; kk < T; kk += 8) {
        float fa[4];
        load_a(fa, a_src, ldp, kk, lane);
        const SplitA a = split_a(fa);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int n0 = (w4 + 4 * n) * 8;
          if (n0 < cols) {
            float fb[2];
            load_bn(fb, b_src, ldd, c0 + n0, kk, lane);
            mma_3xtf32(acc[n], a, fb);
          }
        }
      }
    }
    __syncthreads();
    if (stages == 1 && it + 1 < ntiles) {
      load_qdo(it + 1, 0);
      cp_async_commit();
    }
  }

  const int g = lane >> 2, t = lane & 3;
  float* dst = (half ? dk : dv) + koff;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int n0 = (w4 + 4 * n) * 8;
    if (n0 < cols) {
      const int col = c0 + n0 + 2 * t;
      if (k0 + g < Tk)
        *reinterpret_cast<float2*>(dst + (size_t)(k0 + g) * D + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (k0 + g + 8 < Tk)
        *reinterpret_cast<float2*>(dst + (size_t)(k0 + g + 8) * D + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

constexpr auto DQ_KERNEL = flash_bwd_dq_kernel<4>;
constexpr auto DKDV_KERNEL = flash_bwd_dkdv_kernel<8>;

// Sets each kernel's shared-memory attributes on the current device once
// and whenever a call needs more than before.
cudaError_t prepare(const BwdPlan& pq, const BwdPlan& pkv) {
  static size_t opted_q[MAX_DEVICES] = {};
  static size_t opted_kv[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  cudaError_t err = opt_in(DQ_KERNEL, pq.smem, &opted_q[dev]);
  if (err != cudaSuccess) return err;
  return opt_in(DKDV_KERNEL, pkv.smem, &opted_kv[dev]);
}

bool valid_shape(int B, int H, int Tq, int Tk, int D) {
  return D > 0 && D % 8 == 0 && D <= 1024 && B > 0 && H > 0 && Tq > 0 &&
         Tk > 0;
}

}  // namespace

// ------------------------------------------------------------------ bf16
//
// The same function on bf16 q, k, v, out and dO (the TPU kernel
// `_flash_bwd_kernel` upcasts them to f32 and writes dq, dk, dv in the
// inputs' dtypes): S, P, dP and dS in f32, the -1e30 mask bias added before
// the exp and P not multiplied by the mask (a dead row has P = 1), delta =
// rowsum(dO * out) in f32, every product accumulated in f32 with P and dS
// entering at f32 accuracy (hi + lo bf16 halves), each result rounded to
// bf16 once; lse and delta stay f32.
//
// What bounds it on the card: at the N=256 training shapes (B=8, T <= 1024,
// H*D = 512) one call reads 42 MB and writes 25 MB of bf16 (20 us at 3.35
// TB/s) and does at most 10 B H Tq Tk D = 43 GFLOP (43 us at 989 TFLOP/s),
// both at the AttnBlock 32x32 (H=1, T=1024, D=512). The mma work this
// design issues there: dq computes S and dP once (17.2 GFLOP) and dQ twice
// (hi, lo: 17.2); dkdv computes S^T and dP^T once per column chunk (two:
// 34.4) and dK, dV twice (34.4): 103 GFLOP, 104 us, against 261 us for the
// mma.sync kernels it replaces (S and dP in 4 dq and 8 dkdv column chunks).
//
// Design (D <= 512), the two-kernel split without atomics of the f32
// kernels, each block a 64-row tile (one wgmma M) whose warpgroups run
// wgmma while TMA keeps the inner tiles in flight (full/empty mbarriers,
// one thread issuing every copy as in the forward; zero fill for ragged
// tiles and D's padding). Every output element has one owner and every
// sum runs in one fixed order:
//   * dq: a block owns 64 query rows; Q and dO stay in shared memory, K and
//     V tiles stream. S = Q K^T and dP = dO V^T are SS wgmmas; P and dS
//     are formed in the accumulators' registers and dQ += dS K is an RS
//     wgmma (dS as hi + lo, K read MN-major). Its prologue writes delta for
//     the dkdv kernel.
//   * dkdv: a block owns 64 key rows; K and V stay, Q and dO tiles stream.
//     S^T = K Q^T and dP^T = V dO^T (SS), then dV += P^T dO and dK += dS^T Q
//     (RS, Q and dO read MN-major); the tile's lse and delta are loaded
//     while its SS products run.
//   * P = exp2 of the score in log2 units, one `ex2.approx.ftz` (the -1e30
//     bias and lse scaled by log2(e) alike, so a dead row still has P = 1
//     exactly); a tile whose scores are all live skips the mask's tests.
//   The instantiation follows the width (`plans_wg`):
//   * D <= 32 (the L=128 transformer's heads of 32): one warpgroup,
//     32-column boxes (64-byte swizzle: half the k-steps of S and dP, and
//     dQ, dK, dV as N = 32 products), 64-row (dq) and 32-row (dkdv: 113
//     registers, four blocks an SM) inner tiles, four stages.
//   * D <= 64 (N=256's heads of 64): one warpgroup, one 64-column box,
//     64-row inner tiles, three (dq) and four (dkdv) stages.
//   * 64 < D <= 256 (the L=128 AttnBlock 16x16 at D = 256, test_config_
//     large's heads of 128): one warpgroup, S and dP over all of D, the
//     outputs' boxes split over grid z, each block recomputing S and dP:
//     dq two boxes of dQ a block on 64-row inner tiles, dkdv two boxes
//     each of dK and dV on 32-row inner tiles: at the L=128 AttnBlock
//     (B=16: 64 row tiles) 128 blocks of each kernel.
//   * D > 256 (the N=256 AttnBlocks, D = 512), and 64 < D <= 256 where Tq
//     and Tk are at most 16 (the L=128 4x4 mid block: one inner tile,
//     whose latency splitting D halves): two warpgroups, each computing S
//     and dP (or S^T and dP^T) over its half of the D steps; the partial
//     sums meet in shared memory, so each is computed once per block. dq:
//     each warpgroup owns half of dQ's column boxes (256 columns, 128 f32
//     registers a thread). dkdv: dK and dV of 64 rows at D = 512 are 256
//     KB of f32, the whole register file, so a block owns a chunk of 256
//     of their columns (each warpgroup 128: dK 64 + dV 64 registers) and
//     the two chunks (grid z) each compute S^T and dP^T. Shared memory at
//     D = 512, 16-row inner tiles: the two resident tiles 2 x 64 KB + 2
//     stages x (2 x 16 KB) + the S and dP exchange (2 parities x 2
//     warpgroups x 16 floats x 128 threads, 32 KB) = 224 KB, + 1 KB of
//     alignment and the mbarriers: 230,472 of 232,448 bytes, one block of
//     256 threads an SM.
//   (Software-pipelining the one-warpgroup loops as the forward's, the SS
//   products of tile it + 1 issued before the RS products of tile it, was
//   slower on an H100 at every width: 51.6 -> 60.0 us at the L=128
//   self-attention's D = 32, its registers costing blocks an SM.)
// D > 512 (test_config_large.yml's 8x8 AttnBlock in bf16 is D = 1024, the
// most the JAX rule admits) keeps the mma.sync kernels below: 16 rows a
// warp, column chunks (128 for dq, 64 for dkdv) that each recompute S and
// dP, cp.async double buffering. At B=2 they take 0.208 ms a call, SDPA's
// backward 0.215 (device time, scripts/flash_ab.py --dtype bf16).
//
// Measured against the previous design and SDPA's backward on an H100
// (device time per step of each bf16 path, scripts/flash_ab.py --dtype
// bf16): PERF.md section 6. ptxas: no spill, no stack frame.

namespace {

using namespace t2p;

// P = exp(S scale + bias - lse) is computed as exp2 of the same sum in log2
// units: the -1e30 bias and lse times log2(e), so a fully masked row
// (lse = -1e30) still gets BIAS2 - BIAS2 = 0 and P = 1 exactly
constexpr float BIAS2 = -1e30f * LOG2E;

// The resident tiles' and every stage's mbarriers (ST stages): full[s] at
// bar + 8 s, empty[s] at bar + 8 (ST + s), the resident tiles' at
// bar + 16 ST.
template <int ST>
__device__ __forceinline__ void init_bars(uint32_t bar, int warps) {
  for (int s = 0; s < ST; ++s) {
    mbar_init(bar + 8 * s, 1);
    mbar_init(bar + 8 * (ST + s), warps);
  }
  mbar_init(bar + 16 * ST, 1);
  mbar_fence_init();
}

// The copies of both kernels, issued by thread 0: the resident pair (a, b)
// of 64 rows from row r0, and the inner pair (c, d) of `tile` rows of inner
// tile `it` into its stage; `nbox` boxes of `bc` columns each.
template <int ST>
__device__ __forceinline__ void load_resident(const CUtensorMap* a,
                                              const CUtensorMap* b,
                                              uint32_t base, uint32_t bar,
                                              int nbox, int bc, int r0,
                                              int bh) {
  const uint32_t res = WG_ROWS * 2 * bc;
  const uint32_t bar_r = bar + 16 * ST;
  mbar_expect_tx(bar_r, 2 * nbox * res);
  for (int x = 0; x < nbox; ++x) {
    tma_load(base + x * res, a, bar_r, x * bc, r0, bh);
    tma_load(base + (nbox + x) * res, b, bar_r, x * bc, r0, bh);
  }
}

template <int ST>
__device__ __forceinline__ void load_inner(const CUtensorMap* c,
                                           const CUtensorMap* d,
                                           uint32_t base, uint32_t bar,
                                           const WgLayout& L, int nbox,
                                           int bc, int tile, int it,
                                           int bh) {
  const int s = it % ST;
  const uint32_t box = tile * 2 * bc, full = bar + 8 * s;
  const uint32_t st = base + L.stage0 + s * L.stage;
  mbar_expect_tx(full, L.stage);
  for (int x = 0; x < nbox; ++x) {
    tma_load(st + x * box, c, full, x * bc, it * tile, bh);
    tma_load(st + (nbox + x) * box, d, full, x * bc, it * tile, bh);
  }
}

// Thread 0 sets up the barriers and, after the block barrier, issues the
// resident pair (a, b) and the first stages of the inner pair (c, d).
template <int ST>
__device__ __forceinline__ void start_copies(
    const CUtensorMap* a, const CUtensorMap* b, const CUtensorMap* c,
    const CUtensorMap* d, uint32_t base, uint32_t bar, const WgLayout& L,
    int nbox, int bc, int tile, int r0, int ntiles, int bh, int warps) {
  if (threadIdx.x == 0) init_bars<ST>(bar, warps);
  __syncthreads();
  if (threadIdx.x == 0) {
    load_resident<ST>(a, b, base, bar, nbox, bc, r0, bh);
    for (int i = 0; i < ST && i < ntiles; ++i)
      load_inner<ST>(c, d, base, bar, L, nbox, bc, tile, i, bh);
  }
}

// A warp's release of the stage of inner tile `it`; thread 0 then refills
// it with tile it + ST once every warp has released it.
template <int ST>
__device__ __forceinline__ void release_stage(
    const CUtensorMap* c, const CUtensorMap* d, uint32_t base, uint32_t bar,
    const WgLayout& L, int nbox, int bc, int tile, int it, int ntiles,
    int bh) {
  const uint32_t empty = bar + 8 * (ST + it % ST);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
  if (threadIdx.x == 0 && it + ST < ntiles) {
    mbar_wait(empty, (it / ST) & 1);
    load_inner<ST>(c, d, base, bar, L, nbox, bc, tile, it + ST, bh);
  }
}

// Two SS products over this warpgroup's 16-column steps of D, x = A1 B1^T
// and y = A2 B2^T, A* resident tiles of 64 rows at a1, a2, B* inner tiles
// of `tile` rows at b1, b2 (every operand K-major, boxes of BC columns):
// with one warpgroup every step of the `nbox` boxes (the columns past D
// are TMA's zeros), with two the steps [ks0, ks1) of its half.
template <int NWG, int BC, int N>
__device__ __forceinline__ void two_products(float (&x)[N], float (&y)[N],
                                             uint32_t a1, uint32_t b1,
                                             uint32_t a2, uint32_t b2,
                                             int ks0, int ks1, int tile,
                                             int nbox) {
  constexpr int SPB = BC / 16;            // 16-column steps of a box
  constexpr int SHIFT = BC == 64 ? 2 : 1;  // log2(SPB)
  constexpr uint32_t ROWB = 2 * BC;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = y[i] = 0.f;
  fence_regs(x);  // zeroed before the fence, not sunk past it
  fence_regs(y);
  wgmma_fence();
  if (NWG == 1 && nbox == 1) {
#pragma unroll
    for (int kk = 0; kk < SPB; ++kk) {
      wgmma_ss(x, sw_desc<BC>(a1 + kk * 32), sw_desc<BC>(b1 + kk * 32));
      wgmma_ss(y, sw_desc<BC>(a2 + kk * 32), sw_desc<BC>(b2 + kk * 32));
    }
  } else if (NWG == 1) {
    for (int b = 0; b < nbox; ++b) {
      const uint32_t ao = b * WG_ROWS * ROWB, bo = b * tile * ROWB;
#pragma unroll
      for (int kk = 0; kk < SPB; ++kk) {
        wgmma_ss(x, sw_desc<BC>(a1 + ao + kk * 32),
                 sw_desc<BC>(b1 + bo + kk * 32));
        wgmma_ss(y, sw_desc<BC>(a2 + ao + kk * 32),
                 sw_desc<BC>(b2 + bo + kk * 32));
      }
    }
  } else {
    for (int kk = ks0; kk < ks1; ++kk) {
      const uint32_t ao =
          (kk >> SHIFT) * WG_ROWS * ROWB + (kk & (SPB - 1)) * 32;
      const uint32_t bo = (kk >> SHIFT) * tile * ROWB + (kk & (SPB - 1)) * 32;
      wgmma_ss(x, sw_desc<BC>(a1 + ao), sw_desc<BC>(b1 + bo));
      wgmma_ss(y, sw_desc<BC>(a2 + ao), sw_desc<BC>(b2 + bo));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(y);
}

// With two warpgroups, adds the other's partial x and y (buffers by tile
// parity `it`).
template <int NWG, int N>
__device__ __forceinline__ void exchange(float (&x)[N], float (&y)[N],
                                         float* xch, int it, int wg,
                                         int ct) {
  if (NWG > 1) {
    float* buf = xch + (it & 1) * NWG * 2 * N * 128;
    float* mine = buf + wg * 2 * N * 128;
    const float* other = buf + (1 - wg) * 2 * N * 128;
    xch_put(x, mine, ct);
    xch_put(y, mine + N * 128, ct);
    warpgroups_sync(NWG * 128);
    xch_add(x, other, ct);
    xch_add(y, other + N * 128, ct);
  }
}

// This block's boxes of the outputs (grid z: chunks of NWG x NOB boxes) and
// this warpgroup's share of them: first box ob0, nob boxes.
template <int NWG, int NOB>
__device__ __forceinline__ void output_boxes(int nbox, int wg, int& ob0,
                                             int& nob) {
  const int cb0 = blockIdx.z * NWG * NOB;
  const int nbc = min(NWG * NOB, nbox - cb0);
  const int oper = (nbc + NWG - 1) / NWG;
  ob0 = cb0 + wg * oper;
  nob = min(oper, nbc - wg * oper);
}

template <int NWG, int BK, int NOB, int BC, int ST>
__global__ void __launch_bounds__(NWG * 128, NWG == 1 ? 2 : 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const bf16* __restrict__ dout,
                              const bf16* __restrict__ out,
                              const float* __restrict__ lse,
                              float* __restrict__ delta,
                              const unsigned char* __restrict__ mask,
                              bf16* __restrict__ dq, int H, int Tq, int Tk,
                              int D, float scale) {
  constexpr int NS = BK / 2;
  constexpr int NA = BC / 2;  // accumulator floats of one box of dQ
  constexpr uint32_t ROWB = 2 * BC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbox = nboxes(D, BC);
  const WgLayout L = wg_layout(2, nbox, BK, ST, NWG, 2 * NS, ROWB);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u, bar = base + L.bars;
  const uint32_t sq = base, sdo = base + nbox * WG_ROWS * ROWB;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L.xch);
  const int bh = blockIdx.x, q0 = blockIdx.y * WG_ROWS;
  const int ntiles = (Tk + BK - 1) / BK;
  const uint32_t ktile = BK * ROWB;

  start_copies<ST>(&tm_q, &tm_do, &tm_k, &tm_v, base, bar, L, nbox, BC, BK,
                   q0, ntiles, bh, 4 * NWG);
  // the warpgroup, broadcast from lane 0 so that the compiler sees it (and
  // the k-step bounds and box counts drawn from it) uniform across the
  // warp: wgmma in a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);

  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int warp = ct >> 5, g = lane >> 2, t = lane & 3;
  const int nks = (D + 15) >> 4, kper = (nks + NWG - 1) / NWG;
  const int ks0 = wg * kper, ks1 = min(nks, ks0 + kper);
  int ob0, nob;
  output_boxes<NWG, NOB>(nbox, wg, ob0, nob);
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const size_t qoff = (size_t)bh * Tq * D;
  const float scale2 = scale * LOG2E;

  // delta = rowsum(dO * out) and lse of rows g and g + 8 of this warp;
  // each lane of a quad sums every fourth column pair; the first column
  // chunk writes delta for the dkdv kernel
  const int row = q0 + 16 * warp + g;
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    float d = 0.f;
    if (i < Tq) {
      const bf16* go = dout + qoff + (size_t)i * D;
      const bf16* oo = out + qoff + (size_t)i * D;
      for (int c = 2 * t; c < D; c += 8) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(go + c));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(oo + c));
        d = fmaf(a.x, b.x, d);
        d = fmaf(a.y, b.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta_r[r] = d;
    lse_r[r] = i < Tq ? lse[(size_t)bh * Tq + i] * LOG2E : 0.f;
    if (wg == 0 && t == 0 && i < Tq && blockIdx.z == 0)
      delta[(size_t)bh * Tq + i] = d;
  }

  float acc[NOB][NA];
#pragma unroll
  for (int n = 0; n < NOB; ++n)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[n][i] = 0.f;

  mbar_wait(bar + 16 * ST, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % ST;
    mbar_wait(bar + 8 * s, (it / ST) & 1);
    const uint32_t sk = base + L.stage0 + s * L.stage;
    const uint32_t sv = sk + nbox * ktile;

    float sc[NS], dp[NS];  // S = Q K^T, dP = dO V^T
    two_products<NWG, BC>(sc, dp, sq, sk, sdo, sv, ks0, ks1, BK, nbox);
    exchange<NWG>(sc, dp, xch, it, wg, ct);

    // keys of this thread's columns in range (bit 2 j + e: column
    // 8 j + 2 t + e) and unmasked
    const int k0 = it * BK;
    uint32_t in = ~0u, on = ~0u;
    if (mb != nullptr || k0 + BK > Tk) {
      in = on = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          if (key < Tk) {
            in |= 1u << (2 * j + e);
            if (mb == nullptr || mb[key]) on |= 1u << (2 * j + e);
          }
        }
    }
    // dS = P (dP - delta) scale in place of S
    if (in == ~0u && on == ~0u && row + 8 < Tq) {  // every score live
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2_ftz(fmaf(sc[i], scale2, -lse_r[r]));
        sc[i] = p * (dp[i] - delta_r[r]) * scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int bit = 2 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
        float ds = 0.f;
        if (((in >> bit) & 1u) && row + 8 * r < Tq) {
          const float bias = ((on >> bit) & 1u) ? 0.f : BIAS2;
          const float p = exp2_ftz(fmaf(sc[i], scale2, bias) - lse_r[r]);
          ds = p * (dp[i] - delta_r[r]) * scale;
        }
        sc[i] = ds;
      }
    }

    // dQ += dS K: dS as hi + lo A fragments, K MN-major
    uint32_t sh[BK / 16][4], sl[BK / 16][4];
    split_acc(sc, sh, sl);
#pragma unroll
    for (int n = 0; n < NOB; ++n) fence_regs(acc[n]);
    fence_regs(sh);
    fence_regs(sl);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NOB; ++n)
      if (n < nob) {
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const uint64_t db =
              sw_desc<BC>(sk + (ob0 + n) * ktile + j * 16 * ROWB);
          wgmma_rs(acc[n], sl[j], db);
          wgmma_rs(acc[n], sh[j], db);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NOB; ++n) fence_regs(acc[n]);
    fence_regs(sh);
    fence_regs(sl);
    release_stage<ST>(&tm_k, &tm_v, base, bar, L, nbox, BC, BK, it, ntiles,
                      bh);
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < NOB; ++n)
    if (n < nob) {
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = (ob0 + n) * BC + 8 * (i >> 2) + 2 * t;
        if (row + 8 * r < Tq && col < D)
          *reinterpret_cast<uint32_t*>(dqb + (size_t)(row + 8 * r) * D +
                                       col) =
              pack_bf16(acc[n][i], acc[n][i + 1]);
      }
    }
}

template <int NWG, int BQ, int NOB, int BC, int ST>
__global__ void __launch_bounds__(NWG * 128, NWG == 1 ? 2 : 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const unsigned char* __restrict__ mask,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int H, int Tq, int Tk, int D, float scale) {
  constexpr int NS = BQ / 2;
  constexpr int NA = BC / 2;  // accumulator floats of one box of dK or dV
  constexpr uint32_t ROWB = 2 * BC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbox = nboxes(D, BC);
  const WgLayout L = wg_layout(2, nbox, BQ, ST, NWG, 2 * NS, ROWB);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u, bar = base + L.bars;
  const uint32_t sk = base, sv = base + nbox * WG_ROWS * ROWB;
  float* xch = reinterpret_cast<float*>(smem_raw + (base - raw) + L.xch);
  const int bh = blockIdx.x, k0 = blockIdx.y * WG_ROWS;
  const int ntiles = (Tq + BQ - 1) / BQ;
  const uint32_t qtile = BQ * ROWB;

  start_copies<ST>(&tm_k, &tm_v, &tm_q, &tm_do, base, bar, L, nbox, BC, BQ,
                   k0, ntiles, bh, 4 * NWG);
  // the warpgroup, broadcast from lane 0 so that the compiler sees it (and
  // the k-step bounds and box counts drawn from it) uniform across the
  // warp: wgmma in a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);

  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int warp = ct >> 5, g = lane >> 2, t = lane & 3;
  const int nks = (D + 15) >> 4, kper = (nks + NWG - 1) / NWG;
  const int ks0 = wg * kper, ks1 = min(nks, ks0 + kper);
  int ob0, nob;
  output_boxes<NWG, NOB>(nbox, wg, ob0, nob);
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const float scale2 = scale * LOG2E;

  // key rows g and g + 8 of this warp: in range, and their mask bias
  const int key = k0 + 16 * warp + g;
  bool key_in[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_in[r] = key + 8 * r < Tk;
    bias[r] = (key_in[r] && mask && !mask[(size_t)(bh / H) * Tk + key +
                                          8 * r])
                  ? BIAS2
                  : 0.f;
  }

  float acc_v[NOB][NA], acc_k[NOB][NA];
#pragma unroll
  for (int n = 0; n < NOB; ++n)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc_v[n][i] = acc_k[n][i] = 0.f;

  mbar_wait(bar + 16 * ST, 0);
  for (int it = 0; it < ntiles; ++it) {
    // lse and delta of this thread's query columns (8 j + 2 t + e), in
    // flight during the SS products
    const int q0 = it * BQ;
    float lq[BQ / 4], dl[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        lq[2 * j + e] = qi < Tq ? lb[qi] * LOG2E : 0.f;
        dl[2 * j + e] = qi < Tq ? db[qi] : 0.f;
      }
    const int s = it % ST;
    mbar_wait(bar + 8 * s, (it / ST) & 1);
    const uint32_t sq = base + L.stage0 + s * L.stage;
    const uint32_t sdo = sq + nbox * qtile;

    float sc[NS], dp[NS];  // S^T = K Q^T, dP^T = V dO^T
    two_products<NWG, BC>(sc, dp, sk, sq, sv, sdo, ks0, ks1, BQ, nbox);
    exchange<NWG>(sc, dp, xch, it, wg, ct);

    // P^T and dS^T in place of S^T and dP^T
    if (q0 + BQ <= Tq && key_in[1] && bias[0] == 0.f &&
        bias[1] == 0.f) {  // every score live
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        const float p = exp2_ftz(fmaf(sc[i], scale2, -lq[c]));
        sc[i] = p;
        dp[i] = p * (dp[i] - dl[c]) * scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 2 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
        const int qi = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
        float p = 0.f, ds = 0.f;
        if (qi < Tq && key_in[r]) {
          p = exp2_ftz(fmaf(sc[i], scale2, bias[r]) - lq[c]);
          ds = p * (dp[i] - dl[c]) * scale;
        }
        sc[i] = p;
        dp[i] = ds;
      }
    }

    // dV += P^T dO, dK += dS^T Q: P^T and dS^T as hi + lo A fragments,
    // dO and Q MN-major
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
    split_acc(sc, ph, pl);
    split_acc(dp, sh, sl);
#pragma unroll
    for (int n = 0; n < NOB; ++n) {
      fence_regs(acc_v[n]);
      fence_regs(acc_k[n]);
    }
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(sh);
    fence_regs(sl);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NOB; ++n)
      if (n < nob) {
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) {
          const uint32_t off = (ob0 + n) * qtile + j * 16 * ROWB;
          const uint64_t ddo = sw_desc<BC>(sdo + off);
          const uint64_t dqd = sw_desc<BC>(sq + off);
          wgmma_rs(acc_v[n], pl[j], ddo);
          wgmma_rs(acc_v[n], ph[j], ddo);
          wgmma_rs(acc_k[n], sl[j], dqd);
          wgmma_rs(acc_k[n], sh[j], dqd);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NOB; ++n) {
      fence_regs(acc_v[n]);
      fence_regs(acc_k[n]);
    }
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(sh);
    fence_regs(sl);
    release_stage<ST>(&tm_q, &tm_do, base, bar, L, nbox, BC, BQ, it, ntiles,
                      bh);
  }

  const size_t koff = (size_t)bh * Tk * D;
#pragma unroll
  for (int n = 0; n < NOB; ++n)
    if (n < nob) {
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = (ob0 + n) * BC + 8 * (i >> 2) + 2 * t;
        if (key_in[r] && col < D) {
          const size_t o = koff + (size_t)(key + 8 * r) * D + col;
          *reinterpret_cast<uint32_t*>(dk + o) =
              pack_bf16(acc_k[n][i], acc_k[n][i + 1]);
          *reinterpret_cast<uint32_t*>(dv + o) =
              pack_bf16(acc_v[n][i], acc_v[n][i + 1]);
        }
      }
    }
}

using DqWgKernel = void (*)(const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const CUtensorMap,
                            const bf16*, const bf16*, const float*, float*,
                            const unsigned char*, bf16*, int, int, int, int,
                            float);
using DkdvWgKernel = void (*)(const CUtensorMap, const CUtensorMap,
                              const CUtensorMap, const CUtensorMap,
                              const float*, const float*,
                              const unsigned char*, bf16*, bf16*, int, int,
                              int, int, float);

// One warpgroup and 64-row inner tiles up to D = 256: D <= 32 on 32-column
// boxes and D <= 64 on one 64-column box, with 3 or 4 stages of the inner
// tiles in flight; 64 < D <= 256 with the outputs' boxes split over grid
// z (dq two boxes a block, dkdv one), each block computing S and dP over
// all of D, two stages (the resident tiles and a stage take 64 KB each at
// D = 256); then 256 < D <= 512, and 64 < D <= 256 where Tq and Tk are at
// most 16 (the 4x4 mid block: one inner tile, whose latency the split
// halves): two warpgroups splitting D's steps, 16-row inner tiles (dq up
// to 4 boxes of dQ a warpgroup, dkdv up to 2 boxes each of dK and dV)
constexpr DqWgKernel DQ_WG_KERNELS[] = {
    flash_bwd_dq_wgmma_kernel<1, 64, 1, 32, 4>,
    flash_bwd_dq_wgmma_kernel<1, 64, 1, 64, 3>,
    flash_bwd_dq_wgmma_kernel<1, 64, 2, 64, 2>,
    flash_bwd_dq_wgmma_kernel<2, 16, 4, 64, 2>};
constexpr DkdvWgKernel DKDV_WG_KERNELS[] = {
    flash_bwd_dkdv_wgmma_kernel<1, 32, 1, 32, 4>,
    flash_bwd_dkdv_wgmma_kernel<1, 64, 1, 64, 4>,
    flash_bwd_dkdv_wgmma_kernel<1, 32, 2, 64, 2>,
    flash_bwd_dkdv_wgmma_kernel<2, 16, 2, 64, 2>};
// by instantiation: inner tile rows, boxes of the outputs a block owns,
// stages
constexpr int DQ_TILE[] = {64, 64, 64, 16}, DQ_BOXES[] = {1, 1, 2, 8},
              DQ_STAGES[] = {4, 3, 2, 2};
constexpr int DKDV_TILE[] = {32, 64, 32, 16}, DKDV_BOXES[] = {1, 1, 2, 4},
              DKDV_STAGES[] = {4, 4, 2, 2};

struct WgPlan {
  int nwg, tile, chunks, idx, threads, box, stages;
  dim3 grid;
  size_t smem;
};

// The dq plan and the dkdv plan of a shape, false for D > 512.
bool plans_wg(WgPlan& pq, WgPlan& pkv, int B, int H, int Tq, int Tk,
              int D) {
  if (D > WG_MAX_D) return false;
  const int bc = box_cols(D), nbox = nboxes(D, bc);
  // two warpgroups splitting D's steps
  const bool split = D > 256 || (D > 64 && Tq <= 16 && Tk <= 16);
  pq.idx = split ? 3 : bc == 32 ? 0 : nbox == 1 ? 1 : 2;
  pkv.idx = split ? 3 : bc == 32 ? 0 : nbox == 1 ? 1 : 2;
  pq.chunks = (nbox + DQ_BOXES[pq.idx] - 1) / DQ_BOXES[pq.idx];
  pkv.chunks = (nbox + DKDV_BOXES[pkv.idx] - 1) / DKDV_BOXES[pkv.idx];
  pq.stages = DQ_STAGES[pq.idx];
  pkv.stages = DKDV_STAGES[pkv.idx];
  pq.tile = DQ_TILE[pq.idx];
  pkv.tile = DKDV_TILE[pkv.idx];
  pq.grid = dim3(B * H, (Tq + WG_ROWS - 1) / WG_ROWS, pq.chunks);
  pkv.grid = dim3(B * H, (Tk + WG_ROWS - 1) / WG_ROWS, pkv.chunks);
  for (WgPlan* p : {&pq, &pkv}) {
    p->nwg = split ? 2 : 1;
    p->box = bc;
    p->threads = 128 * p->nwg;
    p->smem = wg_layout(2, nbox, p->tile, p->stages, p->nwg, p->tile, 2 * bc)
                  .total;
  }
  return true;
}

cudaError_t prepare_wg(const WgPlan& pq, const WgPlan& pkv) {
  static size_t opted_q[MAX_DEVICES][4] = {};
  static size_t opted_kv[MAX_DEVICES][4] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  cudaError_t err =
      opt_in(DQ_WG_KERNELS[pq.idx], pq.smem, &opted_q[dev][pq.idx]);
  if (err != cudaSuccess) return err;
  return opt_in(DKDV_WG_KERNELS[pkv.idx], pkv.smem,
                &opted_kv[dev][pkv.idx]);
}

// The mma.sync kernels for D > 512. Shared bytes of either: two resident
// tiles of `warps` x 16 rows (q and dO, or k and v) and two stages of two
// inner tiles of t rows.
size_t bwd16_smem(int D, int warps, int t) {
  const int ld = pad_ld16(round16(D));
  return sizeof(bf16) *
         ((size_t)2 * warps * ROWS * ld + (size_t)2 * 2 * t * ld);
}

// `rows` is the length the grid walks (Tq for dq, Tk for dkdv), `loop` the
// length the block's inner loop walks.
bool plan_bwd16(Bf16Plan& p, int B, int H, int rows, int loop, int D,
                bool dkdv) {
  p.dc = dkdv ? 64 : 128;
  p.nchunk = (D + p.dc - 1) / p.dc;
  p.idx = 0;
  return plan_bf16(p, B * H, rows, loop, 32,
                   [&](int warps, int t) { return bwd16_smem(D, warps, t); });
}

// NO: 8-column tiles of dQ a warp holds; TN: the most 8-row tiles of the
// inner (key) tile.
template <int NO, int TN>
__global__ void __launch_bounds__(4 * 32) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const bf16* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, const unsigned char* __restrict__ mask,
    bf16* __restrict__ dq, int H, int Tq, int Tk, int D, int dc, int T,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int D16 = round16(D), ld = pad_ld16(D16);
  const int rows = (blockDim.x >> 5) * ROWS;
  const int nn = T >> 3;
  const int stage = 2 * T * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* sq = smem;                  // rows x ld
  bf16* sdo = sq + rows * ld;       // rows x ld
  bf16* stage0 = sdo + rows * ld;   // 2 stages x (k tile, v tile)

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int c0 = blockIdx.z * dc;
  const int cols = min(dc, D - c0);
  const size_t qoff = (size_t)bh * Tq * D;
  const bf16* kb = k + (size_t)bh * Tk * D;
  const bf16* vb = v + (size_t)bh * Tk * D;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tk + T - 1) / T;

  if (D16 != D) {
    zero_pad16(sq, ld, 2 * rows, D);
    zero_pad16(stage0, ld, 4 * T, D);
  }
  auto load_kv = [&](int it, int s) {
    bf16* sk = stage0 + s * stage;
    load_tile_async16(sk, ld, kb, D, it * T, T, Tk, 0, D);
    load_tile_async16(sk + T * ld, ld, vb, D, it * T, T, Tk, 0, D);
  };
  load_tile_async16(sq, ld, q + qoff, D, q0, rows, Tq, 0, D);
  load_tile_async16(sdo, ld, dout + qoff, D, q0, rows, Tq, 0, D);
  load_kv(0, 0);
  cp_async_commit();

  // delta = rowsum(dO * out) and lse of rows g and g + 8 of this warp; each
  // lane of a quad sums every fourth column pair
  const int row = q0 + warp * ROWS + g;
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    float d = 0.f;
    if (i < Tq) {
      const bf16* go = dout + qoff + (size_t)i * D;
      const bf16* oo = out + qoff + (size_t)i * D;
      for (int c = 2 * t; c < D; c += 8) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(go + c));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(oo + c));
        d = fmaf(a.x, b.x, d);
        d = fmaf(a.y, b.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta_r[r] = d;
    lse_r[r] = i < Tq ? lse[(size_t)bh * Tq + i] : 0.f;
    if (t == 0 && i < Tq && blockIdx.z == 0) delta[(size_t)bh * Tq + i] = d;
  }

  const bf16* sqw = sq + warp * ROWS * ld;
  const bf16* sdow = sdo + warp * ROWS * ld;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
    const bf16* sv = sk + T * ld;

    float sc[TN][4], dp[TN][4];  // S = q k^T and dP = dO v^T, 16 x T
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
    for (int kk = 0; kk < D16; kk += 16) {
      uint32_t a[4], ad[4];
      load_a16(a, sqw, ld, kk, lane);
      load_a16(ad, sdow, ld, kk, lane);
#pragma unroll
      for (int n = 0; n < TN; ++n)
        if (n < nn) {
          uint32_t b[2];
          load_bt16(b, sk, ld, n * 8, kk, lane);
          mma_bf16(sc[n], a, b);
          load_bt16(b, sv, ld, n * 8, kk, lane);
          mma_bf16(dp[n], ad, b);
        }
    }
    const int k0 = it * T;
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        float ds = 0.f;
        if (n < nn && key < Tk && row + 8 * r < Tq) {
          const float bias = (mb && !mb[key]) ? -1e30f : 0.f;
          const float p = expf(sc[n][i] * scale + bias - lse_r[r]);
          ds = p * (dp[n][i] - delta_r[r]) * scale;
        }
        sc[n][i] = ds;
      }
    // dQ (16 x cols) += dS k[:, c0:c0+cols]
#pragma unroll
    for (int j = 0; j < TN / 2; ++j)
      if (2 * j < nn) {
        const SplitA16 a = split_c_to_a(sc[2 * j], sc[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          if (n * 8 < cols) {
            uint32_t b[2];
            load_bn16(b, sk, ld, c0 + n * 8, j * 16, lane);
            mma_split(acc[n], a, b);
          }
      }
    __syncthreads();  // the stage is read; the next prefetch may refill it
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int n = 0; n < NO; ++n)
    if (n * 8 < cols) {
      const int col = c0 + n * 8 + 2 * t;
      if (row < Tq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)row * D + col) =
            pack_bf16(acc[n][0], acc[n][1]);
      if (row + 8 < Tq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)(row + 8) * D + col) =
            pack_bf16(acc[n][2], acc[n][3]);
    }
}

// NO: 8-column tiles of dK (and of dV) a warp holds; TN: the most 8-row
// tiles of the inner (query) tile.
template <int NO, int TN>
__global__ void __launch_bounds__(4 * 32) flash_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const unsigned char* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int Tq, int Tk, int D, int dc, int T,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int D16 = round16(D), ld = pad_ld16(D16);
  const int rows = (blockDim.x >> 5) * ROWS;
  const int nn = T >> 3;
  const int stage = 2 * T * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* sk = smem;                 // rows x ld
  bf16* sv = sk + rows * ld;       // rows x ld
  bf16* stage0 = sv + rows * ld;   // 2 stages x (q tile, dO tile)

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * rows;
  const int c0 = blockIdx.z * dc;
  const int cols = min(dc, D - c0);
  const size_t koff = (size_t)bh * Tk * D;
  const bf16* qb = q + (size_t)bh * Tq * D;
  const bf16* dob = dout + (size_t)bh * Tq * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const int ntiles = (Tq + T - 1) / T;

  if (D16 != D) {
    zero_pad16(sk, ld, 2 * rows, D);
    zero_pad16(stage0, ld, 4 * T, D);
  }
  auto load_qdo = [&](int it, int s) {
    bf16* sq = stage0 + s * stage;
    load_tile_async16(sq, ld, qb, D, it * T, T, Tq, 0, D);
    load_tile_async16(sq + T * ld, ld, dob, D, it * T, T, Tq, 0, D);
  };
  load_tile_async16(sk, ld, k + koff, D, k0, rows, Tk, 0, D);
  load_tile_async16(sv, ld, v + koff, D, k0, rows, Tk, 0, D);
  load_qdo(0, 0);
  cp_async_commit();

  // keys g and g + 8 of this warp: in range, and their mask bias
  const int key = k0 + warp * ROWS + g;
  bool key_in[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_in[r] = key + 8 * r < Tk;
    bias[r] = (key_in[r] && mb && !mb[key + 8 * r]) ? -1e30f : 0.f;
  }

  const bf16* skw = sk + warp * ROWS * ld;
  const bf16* svw = sv + warp * ROWS * ld;
  float acc_v[NO][4], acc_k[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_v[n][i] = acc_k[n][i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      load_qdo(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sq = stage0 + (it & 1) * stage;
    const bf16* sdo = sq + T * ld;

    float sc[TN][4], dp[TN][4];  // S^T = k q^T and dP^T = v dO^T, 16 x T
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
    for (int kk = 0; kk < D16; kk += 16) {
      uint32_t a[4], av[4];
      load_a16(a, skw, ld, kk, lane);
      load_a16(av, svw, ld, kk, lane);
#pragma unroll
      for (int n = 0; n < TN; ++n)
        if (n < nn) {
          uint32_t b[2];
          load_bt16(b, sq, ld, n * 8, kk, lane);
          mma_bf16(sc[n], a, b);
          load_bt16(b, sdo, ld, n * 8, kk, lane);
          mma_bf16(dp[n], av, b);
        }
    }
    const int q0 = it * T;
#pragma unroll
    for (int n = 0; n < TN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + n * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        float p = 0.f, ds = 0.f;
        if (n < nn && qi < Tq && key_in[r]) {
          p = expf(sc[n][i] * scale + bias[r] - lb[qi]);
          ds = p * (dp[n][i] - db[qi]) * scale;
        }
        sc[n][i] = p;
        dp[n][i] = ds;
      }
    // dV (16 x cols) += P^T dO[:, c0:], dK += dS^T q[:, c0:]
#pragma unroll
    for (int j = 0; j < TN / 2; ++j)
      if (2 * j < nn) {
        const SplitA16 ap = split_c_to_a(sc[2 * j], sc[2 * j + 1]);
        const SplitA16 as = split_c_to_a(dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n)
          if (n * 8 < cols) {
            uint32_t b[2];
            load_bn16(b, sdo, ld, c0 + n * 8, j * 16, lane);
            mma_split(acc_v[n], ap, b);
            load_bn16(b, sq, ld, c0 + n * 8, j * 16, lane);
            mma_split(acc_k[n], as, b);
          }
      }
    __syncthreads();  // the stage is read; the next prefetch may refill it
  }

#pragma unroll
  for (int n = 0; n < NO; ++n)
    if (n * 8 < cols) {
      const int col = c0 + n * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (key_in[r]) {
          const size_t o = koff + (size_t)(key + 8 * r) * D + col;
          *reinterpret_cast<uint32_t*>(dk + o) =
              pack_bf16(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv + o) =
              pack_bf16(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
        }
    }
}

using Dq16Kernel = void (*)(const bf16*, const bf16*, const bf16*,
                            const bf16*, const bf16*, const float*, float*,
                            const unsigned char*, bf16*, int, int, int, int,
                            int, int, float);
using Dkdv16Kernel = void (*)(const bf16*, const bf16*, const bf16*,
                              const bf16*, const float*, const float*,
                              const unsigned char*, bf16*, bf16*, int, int,
                              int, int, int, int, float);

// chunks of 128 for dq and 64 for dkdv, inner tiles up to 32 rows
constexpr Dq16Kernel DQ16_KERNEL = flash_bwd_dq_bf16_kernel<16, 4>;
constexpr Dkdv16Kernel DKDV16_KERNEL = flash_bwd_dkdv_bf16_kernel<8, 4>;

cudaError_t prepare16(const Bf16Plan& pq, const Bf16Plan& pkv) {
  static size_t opted_q[MAX_DEVICES] = {};
  static size_t opted_kv[MAX_DEVICES] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  cudaError_t err = opt_in(DQ16_KERNEL, pq.smem, &opted_q[dev]);
  if (err != cudaSuccess) return err;
  return opt_in(DKDV16_KERNEL, pkv.smem, &opted_kv[dev]);
}

bool plans16(Bf16Plan& pq, Bf16Plan& pkv, int B, int H, int Tq, int Tk,
             int D) {
  return plan_bwd16(pq, B, H, Tq, Tk, D, false) &&
         plan_bwd16(pkv, B, H, Tk, Tq, D, true);
}

}  // namespace

// As t2p_flash_bwd_f32, with q, k, v, dout, out, dq, dk and dv bf16 (lse and
// the delta scratch stay float32).
extern "C" int t2p_flash_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* out,
                                  const void* lse, void* delta,
                                  const void* mask, void* dq, void* dk,
                                  void* dv, int B, int H, int Tq, int Tk,
                                  int D, float scale, void* stream) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, dout, out, dq, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  const bf16* gh = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const unsigned char* mf = static_cast<const unsigned char*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgPlan wq{}, wkv{};
  if (plans_wg(wq, wkv, B, H, Tq, Tk, D)) {
    const int bh = B * H, bc = wq.box;
    CUtensorMap mq, mdo, mk, mv, mq_t, mdo_t, mk_t, mv_t;
    if (!tensor_map(&mq, q, bh, Tq, D, WG_ROWS, bc, 2) ||
        !tensor_map(&mdo, dout, bh, Tq, D, WG_ROWS, bc, 2) ||
        !tensor_map(&mk_t, k, bh, Tk, D, wq.tile, bc, 2) ||
        !tensor_map(&mv_t, v, bh, Tk, D, wq.tile, bc, 2) ||
        !tensor_map(&mk, k, bh, Tk, D, WG_ROWS, bc, 2) ||
        !tensor_map(&mv, v, bh, Tk, D, WG_ROWS, bc, 2) ||
        !tensor_map(&mq_t, q, bh, Tq, D, wkv.tile, bc, 2) ||
        !tensor_map(&mdo_t, dout, bh, Tq, D, wkv.tile, bc, 2))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare_wg(wq, wkv);
    if (err != cudaSuccess) return (int)err;
    DQ_WG_KERNELS[wq.idx]<<<wq.grid, wq.threads, wq.smem, s>>>(
        mq, mdo, mk_t, mv_t, gh, static_cast<const bf16*>(out), lf, df, mf,
        static_cast<bf16*>(dq), H, Tq, Tk, D, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    DKDV_WG_KERNELS[wkv.idx]<<<wkv.grid, wkv.threads, wkv.smem, s>>>(
        mk, mv, mq_t, mdo_t, lf, df, mf, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, Tq, Tk, D, scale);
    return (int)cudaGetLastError();
  }
  Bf16Plan pq{}, pkv{};
  if (!plans16(pq, pkv, B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare16(pq, pkv);
  if (err != cudaSuccess) return (int)err;
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
  DQ16_KERNEL<<<pq.grid, 32 * pq.warps, pq.smem, s>>>(
      qh, kh, vh, gh, static_cast<const bf16*>(out), lf, df, mf,
      static_cast<bf16*>(dq), H, Tq, Tk, D, pq.dc, pq.t, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  DKDV16_KERNEL<<<pkv.grid, 32 * pkv.warps, pkv.smem, s>>>(
      qh, kh, vh, gh, lf, df, mf, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Tq, Tk, D, pkv.dc, pkv.t, scale);
  return (int)cudaGetLastError();
}

// The bf16 kernels' launch plans, the dq kernel's then the dkdv kernel's,
// each in t2p_flash_fwd_bf16_plan's layout of twelve (box columns 0 and a
// cluster of 1 for the mma.sync kernels).
extern "C" int t2p_flash_bwd_bf16_plan(int B, int H, int Tq, int Tk, int D,
                                       int* out) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  WgPlan w[2] = {};
  Bf16Plan p[2] = {};
  const bool wgmma = plans_wg(w[0], w[1], B, H, Tq, Tk, D);
  if (!wgmma && !plans16(p[0], p[1], B, H, Tq, Tk, D))
    return (int)cudaErrorInvalidValue;
  const bool ready = wgmma ? prepare_wg(w[0], w[1]) == cudaSuccess
                           : prepare16(p[0], p[1]) == cudaSuccess;
  for (int i = 0; i < 2; ++i) {
    int per_sm = -1;
    cudaError_t err = cudaErrorInvalidValue;
    if (ready && wgmma)
      err = i == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, DQ_WG_KERNELS[w[0].idx], w[0].threads,
                         w[0].smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, DKDV_WG_KERNELS[w[1].idx], w[1].threads,
                         w[1].smem);
    else if (ready)
      err = i == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, DQ16_KERNEL, 32 * p[0].warps, p[0].smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, DKDV16_KERNEL, 32 * p[1].warps,
                         p[1].smem);
    if (err != cudaSuccess) per_sm = -1;
    const dim3 grid = wgmma ? w[i].grid : p[i].grid;
    int* o = out + 12 * i;
    o[0] = wgmma ? w[i].nwg : 0;
    o[1] = wgmma ? w[i].chunks : p[i].nchunk;
    o[2] = wgmma ? w[i].stages : 2;
    o[3] = wgmma ? w[i].tile : p[i].t;
    o[4] = wgmma ? WG_ROWS : ROWS * p[i].warps;
    o[5] = (int)(grid.x * grid.y * grid.z);
    o[6] = (int)(wgmma ? w[i].smem : p[i].smem);
    o[7] = per_sm;
    o[8] = wgmma ? w[i].threads : 32 * p[i].warps;
    o[9] = wgmma;
    o[10] = wgmma ? w[i].box : 0;
    o[11] = 1;
  }
  return 0;
}

// ------------------------------------------------------- f32, TF32 wgmma
//
// The f32 backward for D <= 512: TF32 wgmma in 3xTF32 form, TMA tiles, the
// transposes and lo tiles of the B operands made in shared memory
// (wgmma_tf32.cuh says why the operands look as they do). The two kernels
// of the split above, without atomics: every output element has one owner,
// which sums its products in a fixed order.
//
// Design. A block is one warpgroup (128 threads) on 64 rows (dq: query
// rows; dkdv: key rows). Its A operands (dq: Q and dO; dkdv: K and V) stay
// in shared memory for the whole walk of the inner tiles (dq: key tiles of
// BK; dkdv: query tiles of 32), so no A byte is read twice: 64 rows of both
// at D = 128 are 64 KB, and above D = 128 (the AttnBlock, D = 256 and 512)
// the blocks of a row tile form a thread block cluster of D / 128 blocks,
// each holding its 128 columns of A (4 boxes), computing S and dP (or S^T
// and dP^T) over them, and owning those columns of the outputs: the
// partial sums meet in the backward's scratch in device memory
// (`cluster_sum`, one cluster barrier an inner tile), so S and dP are
// computed once per row tile. An inner tile is walked in steps, each one
// stage of a TMA ring of two or three slots:
//   * product steps, `kc` boxes of the block's D each: the block writes the
//     lo tile of the B boxes, then RS wgmmas with A's fragments split in
//     registers: dq: S = Q K^T, then dP = dO V^T; dkdv: S^T = K Q^T, then
//     dP^T = V dO^T.
//   * then P and dS in registers (P = exp2 of the score in log2 units, the
//     -1e30 bias and lse scaled alike, so a fully masked row still has
//     P = 1), split into hi and lo A fragments.
//   * output steps, `vc` boxes of the block's outputs each, transposed with
//     the keys (or queries) in k-slot order: dq: dQ += dS K; dkdv: dV +=
//     P^T dO, then dK += dS^T Q.
// The dq kernel's prologue writes delta = rowsum(dO * out) for the dkdv
// kernel. Registers: dq's dQ boxes (2 at D <= 64, 4 above: 32 or 64) or
// dkdv's dK and dV boxes (2 or 4 each: 64 or 128) with S, dP and the split
// P, dS. Without a cluster, where the grid would leave SMs empty, the
// blocks of a row tile split the output boxes (grid z), each computing S
// and dP. The plan takes the largest steps that fit, then two blocks an
// SM: every block of the paths fits two an SM, the clusters' too (A 64 KB,
// 4-box steps, 112 KB), which lets 62 clusters of 4 run at once on an H100
// (`max_clusters` of the plan): test_config's 32 row tiles at B=2 take one
// wave (with the exchange in shared memory, 96 KB more, one block an SM
// let 30 run, and the D = 512 backward took 1.49 ms against 0.85).
// What holds it back at D = 512: each inner tile waits on a cluster
// barrier, and every K, V (or q, dO) tile is converted by each block that
// reads it.

namespace {

using namespace t2p;

// Byte offsets of a TF32 backward kernel's shared memory from its 1024-byte
// aligned base: the resident A tiles (two tiles of nba boxes of 64 rows: Q
// and dO for dq, K and V for dkdv), `nst` slots of the step ring, the
// conversion buffer (the lo tile of a product step, or the hi and lo of an
// output step's transposed boxes), the mbarriers (resident, then slot
// full x nst). The dynamic shared memory of a block with no
// static shared memory starts 1024-byte aligned (at offset 1024, past the
// block's reserved kilobyte), which the kernels check.
struct TfBwdLayout {
  uint32_t ring, slot, conv, bars, total;
};

__host__ __device__ inline TfBwdLayout tf_bwd_layout(int nba, int tile,
                                                     int kc, int vc,
                                                     int nst) {
  TfBwdLayout l;
  const uint32_t bstep = (uint32_t)(kc * tile * 128);
  const uint32_t ostep = (uint32_t)(vc * tile * 128);
  l.ring = 2u * (uint32_t)nba * 8192u;
  l.slot = bstep > ostep ? bstep : ostep;
  l.conv = l.ring + nst * l.slot;
  l.bars = l.conv + (bstep > 2 * ostep ? bstep : 2 * ostep);
  l.total = l.bars + 8 * (nst + 1);
  return l;
}

// Thread 0's copies of step s, into a slot at dst completing on `full`.
// Step r of an inner tile (a tile is `per` steps): r < 2 nks: product step
// c = r % nks of the first (r < nks: B boxes from b1) or the second
// product (b2), kc boxes of D from box0; then the output steps of the
// tile, c of them (dq: K's boxes; dkdv: dO's, then q's): vc boxes from
// ob0 + c vc of o1 (the first nds steps) or o2.
__device__ __forceinline__ void bwd_step_load(
    int s, int per, int nks, int nds, int kc, int vc, int tile, int box0,
    int ob0, const CUtensorMap* b1, const CUtensorMap* b2,
    const CUtensorMap* o1, const CUtensorMap* o2, uint32_t dst, uint32_t full,
    int bh) {
  const int it = s / per, r = s % per;
  if (r < 2 * nks) {
    const int which = r / nks, c = r % nks;
    mbar_expect_tx(full, (uint32_t)(kc * tile * 128));
    for (int b = 0; b < kc; ++b)
      tma_load(dst + b * tile * 128, which ? b2 : b1, full,
               (box0 + c * kc + b) * F32_BOX, it * tile, bh);
  } else {
    const int r2 = r - 2 * nks, which = r2 / nds, c = r2 % nds;
    mbar_expect_tx(full, (uint32_t)(vc * tile * 128));
    for (int b = 0; b < vc; ++b)
      tma_load(dst + b * tile * 128, which ? o2 : o1, full,
               (ob0 + c * vc + b) * F32_BOX, it * tile, bh);
  }
}

// Thread 0's copy of the resident A tiles: nba boxes from box0 of a1 and
// a2, 64 rows from row0, completing on `full`.
__device__ __forceinline__ void bwd_load_a(const CUtensorMap* a1,
                                           const CUtensorMap* a2,
                                           uint32_t base, uint32_t full,
                                           int nba, int box0, int row0,
                                           int bh) {
  mbar_expect_tx(full, (uint32_t)(2 * nba * 8192));
  for (int b = 0; b < nba; ++b) {
    tma_load(base + b * 8192, a1, full, (box0 + b) * F32_BOX, row0, bh);
    tma_load(base + (nba + b) * 8192, a2, full, (box0 + b) * F32_BOX, row0,
             bh);
  }
}

// A product step of either kernel (step s in slot s % nst): the lo tile of
// the B boxes, then x (64 x N) += A B^T over kc boxes of the resident A at
// `a`; thread 0 then refills the slot with step s + nst.
template <int N, class Load>
__device__ __forceinline__ void bwd_product(float (&x)[N], int s, int nsteps,
                                            int nst, uint32_t ring,
                                            uint32_t slot, uint32_t conv,
                                            uint32_t bar, uint32_t a, int kc,
                                            int tile, int ct, int warp, int g,
                                            int t, Load load) {
  const uint32_t sl = ring + (s % nst) * slot;
  mbar_wait(bar + 8 * (s % nst), (s / nst) & 1);
  lo_tile(conv, sl, (uint32_t)(kc * tile * 128), ct);
  fence_proxy_async();
  __syncthreads();
  issue_abt(x, a, sl, conv, kc, tile, warp, g, t);
  __syncthreads();  // the slot and the lo tile are read
  if (ct == 0 && s + nst < nsteps) load(s + nst);
}

// An output step (step s): the transpose of its vc boxes into the
// conversion buffer (hi, then lo), then acc (the boxes of this step) += A B
// with A the split fragments (a_hi, a_lo) of the inner tile.
template <int NOB, int NK, class Load>
__device__ __forceinline__ void bwd_output(
    float (&acc)[NOB][16], uint32_t (&a_hi)[NK][4], uint32_t (&a_lo)[NK][4],
    int s, int c, int nsteps, int nst, uint32_t ring, uint32_t slot,
    uint32_t conv, uint32_t bar, int vc, int nob, int tile, int ct,
    Load load) {
  const uint32_t sl = ring + (s % nst) * slot;
  const uint32_t lo = conv + (uint32_t)(vc * tile * 128);
  mbar_wait(bar + 8 * (s % nst), (s / nst) & 1);
  transpose_tile(conv, lo, sl, tile, vc, ct);
  fence_proxy_async();
  __syncthreads();
  if (ct == 0 && s + nst < nsteps) load(s + nst);  // the slot is read
#pragma unroll
  for (int n = 0; n < NOB; ++n) fence_regs(acc[n]);
  fence_a(a_hi);
  fence_a(a_lo);
  wgmma_fence();
#pragma unroll
  for (int n = 0; n < NOB; ++n) {
    const int b = n - c * vc;  // this step's box b of the block's box n
    if (b >= 0 && b < vc && n < nob) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const uint32_t off =
            (uint32_t)((((j >> 2) * vc) + b) * 4096 + (j & 3) * 32);
        wgmma_3x(acc[n], a_hi[j], a_lo[j], sw128_desc(conv + off),
                 sw128_desc(lo + off));
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NOB; ++n) fence_regs(acc[n]);
  fence_a(a_hi);
  fence_a(a_lo);
  __syncthreads();  // the buffer is read: the next step may rewrite it
}

// Stores 64-row accumulators (boxes ob0 + n, n < nob) at rows row, row + 8
// (< limit) of a (rows, D) f32 matrix.
template <int NOB>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[NOB][16],
                                           int row, int limit, int ob0,
                                           int nob, int D, int t) {
#pragma unroll
  for (int n = 0; n < NOB; ++n)
    if (n < nob) {
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = (i >> 1) & 1;
        const int col = (ob0 + n) * F32_BOX + 8 * (i >> 2) + 2 * t;
        if (row + 8 * r < limit && col < D)
          *reinterpret_cast<float2*>(dst + (size_t)(row + 8 * r) * D + col) =
              make_float2(acc[n][i], acc[n][i + 1]);
      }
    }
}

// Where a block and its boxes lie: the batch*head, this block's rank in
// its cluster of ncl (blockIdx.x = bh * ncl + rank), its boxes of D
// (box0, nba of them for A and B) and of the outputs (ob0, nob).
struct BwdPlace {
  int bh, rank, box0, nba, ob0, nob;
};

__device__ __forceinline__ BwdPlace bwd_place(int ncl, int cb, int nbox) {
  BwdPlace p;
  p.rank = ncl > 1 ? cluster_rank() : 0;
  p.bh = blockIdx.x / ncl;
  if (ncl > 1) {  // 4 boxes a block, all of its outputs
    p.box0 = 4 * p.rank;
    p.nba = 4;
    p.ob0 = p.box0;
    p.nob = min(4, nbox - p.box0);
  } else {  // all of D; the z-chunk cb of the outputs
    p.box0 = 0;
    p.nba = nbox;
    p.ob0 = blockIdx.z * cb;
    p.nob = min(cb, nbox - p.ob0);
  }
  return p;
}

// The backward's scratch (floats from `delta`): delta, (B*H, Tq), then the
// clusters' exchange buffers (`cluster_sum`): for each cluster (a row tile
// of a batch*head) two buffers (by inner tile) of ncl slots of the S and dP
// partials, 2 x tile / 2 floats a thread; the dq kernel's clusters, then
// dkdv's over the same floats (the kernels run one after the other).
__host__ __device__ inline size_t bwd_xch_offset(int bh, int Tq) {
  return ((size_t)bh * Tq + 31) / 32 * 32;  // 128-byte aligned
}

__host__ __device__ inline size_t bwd_xch_floats(int ncl, int tile) {
  return ncl > 1 ? (size_t)2 * ncl * tile * 128 : 0;
}

template <int BK, int NOB>
__global__ void __launch_bounds__(128, 1) flash_bwd_dq_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, const unsigned char* __restrict__ mask,
    float* __restrict__ dq, int H, int Tq, int Tk, int D, int cb, int kc,
    int vc, int nst, int ncl, float scale) {
  constexpr int NS = BK / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbox = f32_boxes(D);
  const BwdPlace P = bwd_place(ncl, cb, nbox);
  const int nks = (P.nba + kc - 1) / kc, nba = nks * kc;
  const TfBwdLayout L = tf_bwd_layout(nba, BK, kc, vc, nst);
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte bases
  const uint32_t ring = base + L.ring, conv = base + L.conv;
  const uint32_t bar = base + L.bars + 8;  // slot full x nst
  const uint32_t bar_a = base + L.bars;   // the resident A tiles
  const int bh = P.bh, q0 = blockIdx.y * WG_ROWS;
  const int nds = (P.nob + vc - 1) / vc;
  const int per = 2 * nks + nds;
  const int ntiles = (Tk + BK - 1) / BK, nsteps = ntiles * per;
  const int ct = threadIdx.x, lane = ct & 31, warp = ct >> 5;
  const int g = lane >> 2, t = lane & 3;

  auto load = [&](int s) {
    bwd_step_load(s, per, nks, nds, kc, vc, BK, P.box0, P.ob0, &tm_k, &tm_v,
                  &tm_k, &tm_k, ring + (s % nst) * L.slot, bar + 8 * (s % nst),
                  bh);
  };
  if (ct == 0) {
    for (int i = 0; i <= nst; ++i) mbar_init(bar_a + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (ct == 0) {
    bwd_load_a(&tm_q, &tm_do, base, bar_a, nba, P.box0, q0, bh);
    for (int s = 0; s < nst && s < nsteps; ++s) load(s);
  }
  if (ncl > 1) cluster_sync();  // every peer runs before any reads its memory

  // delta = rowsum(dO * out) and lse of rows g and g + 8 of this warp, over
  // all of D; each lane of a quad sums every fourth column pair (the same
  // count in each)
  const size_t qoff = (size_t)bh * Tq * D;
  const int row = q0 + 16 * warp + g;
  float delta_r[2], lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    float d = 0.f;
    if (i < Tq) {
      const float* go = dout + qoff + (size_t)i * D + 2 * t;
      const float* oo = out + qoff + (size_t)i * D + 2 * t;
      for (int c = 0; c < D / 8; ++c) {
        const float2 a = *reinterpret_cast<const float2*>(go + 8 * c);
        const float2 b = *reinterpret_cast<const float2*>(oo + 8 * c);
        d = fmaf(a.x, b.x, d);
        d = fmaf(a.y, b.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    delta_r[r] = d;
    lse_r[r] = i < Tq ? lse[(size_t)bh * Tq + i] * LOG2E : 0.f;
    if (blockIdx.z == 0 && P.rank == 0 && t == 0 && i < Tq)
      delta[(size_t)bh * Tq + i] = d;
  }
  const unsigned char* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;
  const float scale2 = scale * LOG2E;

  float acc[NOB][16];
#pragma unroll
  for (int n = 0; n < NOB; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[n][i] = 0.f;
  uint32_t dh[BK / 8][4], dl[BK / 8][4];

  mbar_wait(bar_a, 0);
  int s = 0;
  for (int it = 0; it < ntiles; ++it) {
    float sc[NS], dp[NS];  // S = Q K^T, dP = dO V^T
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    for (int c = 0; c < nks; ++c, ++s)
      bwd_product(sc, s, nsteps, nst, ring, L.slot, conv, bar,
                  base + c * kc * 8192, kc, BK, ct, warp, g, t, load);
    for (int c = 0; c < nks; ++c, ++s)
      bwd_product(dp, s, nsteps, nst, ring, L.slot, conv, bar,
                  base + (nba + c * kc) * 8192, kc, BK, ct, warp, g, t, load);
    if (ncl > 1)
      cluster_sum(sc, dp,
                  delta + bwd_xch_offset(gridDim.x / ncl, Tq) +
                      (bh * gridDim.y + blockIdx.y) * bwd_xch_floats(ncl, BK) +
                      (it & 1) * ncl * (2 * NS * 128),
                  P.rank, ncl, ct);

    // keys of this thread's columns in range (bit 2 j + e: column
    // 8 j + 2 t + e) and unmasked
    const int k0 = it * BK;
    uint32_t in = ~0u, on = ~0u;
    if (mb != nullptr || k0 + BK > Tk) {
      in = on = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * t + e;
          if (key < Tk) {
            in |= 1u << (2 * j + e);
            if (mb == nullptr || mb[key]) on |= 1u << (2 * j + e);
          }
        }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int bit = 2 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
      float ds = 0.f;
      if (((in >> bit) & 1u) && row + 8 * r < Tq) {
        const float bias = ((on >> bit) & 1u) ? 0.f : BIAS2;
        const float p = exp2f(fmaf(sc[i], scale2, bias) - lse_r[r]);
        ds = p * (dp[i] - delta_r[r]) * scale;
      }
      sc[i] = ds;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) acc_to_a(sc, j, dh[j], dl[j]);

    // dQ += dS K
    for (int c = 0; c < nds; ++c, ++s)
      bwd_output(acc, dh, dl, s, c, nsteps, nst, ring, L.slot, conv, bar, vc,
                 P.nob, BK, ct, load);
  }
  store_rows(dq + qoff, acc, row, Tq, P.ob0, P.nob, D, t);
  if (ncl > 1) cluster_sync();  // no block leaves while a peer may read it
}

template <int BQ, int NOB>
__global__ void __launch_bounds__(128, 1) flash_bwd_dkdv_tf32_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    float* __restrict__ delta, const unsigned char* __restrict__ mask,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
    int D, int cb, int kc, int vc, int nst, int ncl, float scale) {
  constexpr int NS = BQ / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbox = f32_boxes(D);
  const BwdPlace P = bwd_place(ncl, cb, nbox);
  const int nks = (P.nba + kc - 1) / kc, nba = nks * kc;
  const TfBwdLayout L = tf_bwd_layout(nba, BQ, kc, vc, nst);
  const uint32_t base = smem_u32(smem_raw);
  if (base & 1023u) __trap();  // the swizzled tiles need 1024-byte bases
  const uint32_t ring = base + L.ring, conv = base + L.conv;
  const uint32_t bar = base + L.bars + 8;  // slot full x nst
  const uint32_t bar_a = base + L.bars;   // the resident A tiles
  const int bh = P.bh, k0 = blockIdx.y * WG_ROWS;
  const int nds = (P.nob + vc - 1) / vc;
  const int per = 2 * nks + 2 * nds;
  const int ntiles = (Tq + BQ - 1) / BQ, nsteps = ntiles * per;
  const int ct = threadIdx.x, lane = ct & 31, warp = ct >> 5;
  const int g = lane >> 2, t = lane & 3;

  // output steps: dV from dO's boxes, then dK from Q's
  auto load = [&](int s) {
    bwd_step_load(s, per, nks, nds, kc, vc, BQ, P.box0, P.ob0, &tm_q, &tm_do,
                  &tm_do, &tm_q, ring + (s % nst) * L.slot, bar + 8 * (s % nst),
                  bh);
  };
  if (ct == 0) {
    for (int i = 0; i <= nst; ++i) mbar_init(bar_a + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (ct == 0) {
    bwd_load_a(&tm_k, &tm_v, base, bar_a, nba, P.box0, k0, bh);
    for (int s = 0; s < nst && s < nsteps; ++s) load(s);
  }
  if (ncl > 1) cluster_sync();  // every peer runs before any reads its memory

  // key rows g and g + 8 of this warp: in range, and their mask bias
  const int key = k0 + 16 * warp + g;
  bool key_in[2];
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_in[r] = key + 8 * r < Tk;
    bias[r] = (key_in[r] && mask &&
               !mask[(size_t)(bh / H) * Tk + key + 8 * r])
                  ? BIAS2
                  : 0.f;
  }
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const float scale2 = scale * LOG2E;

  float acc_v[NOB][16], acc_k[NOB][16];
#pragma unroll
  for (int n = 0; n < NOB; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc_v[n][i] = acc_k[n][i] = 0.f;
  uint32_t ph[BQ / 8][4], pl[BQ / 8][4], sh[BQ / 8][4], sl[BQ / 8][4];

  mbar_wait(bar_a, 0);
  int s = 0;
  for (int it = 0; it < ntiles; ++it) {
    float st[NS], dpt[NS];  // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < NS; ++i) st[i] = dpt[i] = 0.f;
    for (int c = 0; c < nks; ++c, ++s)
      bwd_product(st, s, nsteps, nst, ring, L.slot, conv, bar,
                  base + c * kc * 8192, kc, BQ, ct, warp, g, t, load);
    for (int c = 0; c < nks; ++c, ++s)
      bwd_product(dpt, s, nsteps, nst, ring, L.slot, conv, bar,
                  base + (nba + c * kc) * 8192, kc, BQ, ct, warp, g, t, load);
    if (ncl > 1)
      cluster_sum(st, dpt,
                  delta + bwd_xch_offset(gridDim.x / ncl, Tq) +
                      (bh * gridDim.y + blockIdx.y) * bwd_xch_floats(ncl, BQ) +
                      (it & 1) * ncl * (2 * NS * 128),
                  P.rank, ncl, ct);

    // lse and delta of this thread's query columns (8 j + 2 t + e)
    const int q0 = it * BQ;
    float lq[BQ / 4], dl[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        lq[2 * j + e] = qi < Tq ? lb[qi] * LOG2E : 0.f;
        dl[2 * j + e] = qi < Tq ? db[qi] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 2 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
      const int qi = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float p = 0.f, ds = 0.f;
      if (qi < Tq && key_in[r]) {
        p = exp2f(fmaf(st[i], scale2, bias[r]) - lq[c]);
        ds = p * (dpt[i] - dl[c]) * scale;
      }
      st[i] = p;
      dpt[i] = ds;
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      acc_to_a(st, j, ph[j], pl[j]);
      acc_to_a(dpt, j, sh[j], sl[j]);
    }

    // dV += P^T dO, then dK += dS^T Q
    for (int c = 0; c < nds; ++c, ++s)
      bwd_output(acc_v, ph, pl, s, c, nsteps, nst, ring, L.slot, conv, bar, vc,
                 P.nob, BQ, ct, load);
    for (int c = 0; c < nds; ++c, ++s)
      bwd_output(acc_k, sh, sl, s, c, nsteps, nst, ring, L.slot, conv, bar, vc,
                 P.nob, BQ, ct, load);
  }
  const size_t koff = (size_t)bh * Tk * D;
  store_rows(dk + koff, acc_k, key, Tk, P.ob0, P.nob, D, t);
  store_rows(dv + koff, acc_v, key, Tk, P.ob0, P.nob, D, t);
  if (ncl > 1) cluster_sync();  // no block leaves while a peer may read it
}

using TfDqKernel = void (*)(const CUtensorMap, const CUtensorMap,
                            const CUtensorMap, const CUtensorMap,
                            const float*, const float*, const float*, float*,
                            const unsigned char*, float*, int, int, int, int,
                            int, int, int, int, int, float);
using TfDkdvKernel = void (*)(const CUtensorMap, const CUtensorMap,
                              const CUtensorMap, const CUtensorMap,
                              const float*, float*,
                              const unsigned char*, float*, float*, int, int,
                              int, int, int, int, int, int, int, float);

// dq: D <= 64 (64-key tiles, 2 boxes of dQ), 64 < D <= 128 and the
// clusters above (32-key tiles, 4 boxes); dkdv: D <= 64 (2 boxes each of
// dK and dV), above (4 boxes each), 32-query tiles
constexpr TfDqKernel TF_DQ_KERNELS[] = {flash_bwd_dq_tf32_kernel<64, 2>,
                                        flash_bwd_dq_tf32_kernel<32, 4>};
constexpr TfDkdvKernel TF_DKDV_KERNELS[] = {
    flash_bwd_dkdv_tf32_kernel<32, 2>, flash_bwd_dkdv_tf32_kernel<32, 4>};

struct TfBwdPlan {
  int idx, tile, nob, ncl, cb, nz, kc, vc, nst;
  dim3 grid;
  size_t smem;
};

// The plan of one of the two kernels on the TF32 route (`rows` the length
// the grid walks: Tq for dq, Tk for dkdv; `loop` the one its blocks walk):
// the cluster (D / 128 blocks above D = 128), the instantiation, the output
// boxes a block owns (cb) and, without a cluster, z-chunks where the grid
// would leave SMs empty; then the largest steps (kc, vc), two blocks an SM
// where they fit.
bool plan_bwd_tf(TfBwdPlan& p, int B, int H, int rows, int loop, int D,
                 bool dkdv) {
  if (!tf32_route(rows, loop, D)) return false;
  const int nbox = f32_boxes(D);
  p.ncl = nbox > 4 ? (nbox + 3) / 4 : 1;
  p.idx = nbox <= 2 ? 0 : 1;
  p.tile = dkdv || p.idx == 1 ? 32 : 64;
  p.nob = p.idx == 0 ? 2 : 4;
  const int nba = p.ncl > 1 ? 4 : nbox;
  const long blocks = (long)B * H * ((rows + WG_ROWS - 1) / WG_ROWS);
  p.nz = 1;
  p.cb = p.ncl > 1 ? 4 : nbox;
  while (p.ncl == 1 && p.cb > 1 && blocks * 2 * p.nz <= sm_count()) {
    p.nz *= 2;
    p.cb = (nbox + p.nz - 1) / p.nz;
  }
  if (p.ncl == 1) p.nz = (nbox + p.cb - 1) / p.cb;
  // the largest steps first (every step costs two barriers and a drain of
  // the wgmma pipeline: at D = 256 and 512 one block an SM with 4-box steps
  // was a third faster on an H100 than two with 2-box steps), then two
  // blocks an SM, then a third ring slot
  p.kc = p.vc = 1;
  p.nst = 2;
  bool found = false;
  for (int kc : {4, 2, 1})
    for (int vc : {2, 1})
      for (const size_t limit : {(size_t)113 * 1024, (size_t)227 * 1024})
        for (int nst : {3, 2})
          if (!found && kc <= nba && vc <= p.cb &&
              tf_bwd_layout((nba + kc - 1) / kc * kc, p.tile, kc, vc, nst)
                      .total <= limit) {
            p.kc = kc;
            p.vc = vc;
            p.nst = nst;
            found = true;
          }
  p.smem = tf_bwd_layout((nba + p.kc - 1) / p.kc * p.kc, p.tile, p.kc, p.vc,
                         p.nst)
               .total;
  p.grid = dim3(B * H * p.ncl, (rows + WG_ROWS - 1) / WG_ROWS, p.nz);
  return true;
}

cudaError_t prepare_tf(const TfBwdPlan& pq, const TfBwdPlan& pkv) {
  static size_t opted_q[MAX_DEVICES][2] = {};
  static size_t opted_kv[MAX_DEVICES][2] = {};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  cudaError_t err =
      opt_in(TF_DQ_KERNELS[pq.idx], pq.smem, &opted_q[dev][pq.idx]);
  if (err != cudaSuccess) return err;
  return opt_in(TF_DKDV_KERNELS[pkv.idx], pkv.smem, &opted_kv[dev][pkv.idx]);
}

// Launches `kernel` on the plan's grid, a cluster of p.ncl blocks along x.
template <class Kernel, class... Args>
cudaError_t launch_tf(Kernel kernel, const TfBwdPlan& p, cudaStream_t s,
                      Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// Floats of the scratch (`delta`) that t2p_flash_bwd_f32 takes for a
// shape: delta, (B*H, Tq), and for the TF32 kernels' clusters their
// exchange buffers.
extern "C" long long t2p_flash_bwd_f32_scratch(int B, int H, int Tq, int Tk,
                                               int D) {
  if (!valid_shape(B, H, Tq, Tk, D)) return -1;
  TfBwdPlan wq{}, wkv{};
  size_t xch = 0;
  if (plan_bwd_tf(wq, B, H, Tq, Tk, D, false) &&
      plan_bwd_tf(wkv, B, H, Tk, Tq, D, true)) {
    const size_t q = (size_t)wq.grid.x / wq.ncl * wq.grid.y *
                     bwd_xch_floats(wq.ncl, wq.tile);
    const size_t kv = (size_t)wkv.grid.x / wkv.ncl * wkv.grid.y *
                      bwd_xch_floats(wkv.ncl, wkv.tile);
    xch = q > kv ? q : kv;
  }
  return (long long)(bwd_xch_offset(B * H, Tq) + xch);
}

// q, dout, out, dq: (B,H,Tq,D); k, v, dk, dv: (B,H,Tk,D); lse: (B*H,Tq);
// all float32, contiguous, on the device, the tensors of D columns 16-byte
// aligned; mask: (B,Tk) bool bytes (1 = attend) or null. delta is scratch
// of t2p_flash_bwd_f32_scratch floats, 16-byte aligned: the dq kernel
// writes delta = rowsum(dO * out) into its first (B*H, Tq) for the dkdv
// kernel, and the kernels' clusters exchange partial sums in the rest. D is
// a multiple of 8 and at most 1024. Launches the dq kernel and then the
// dkdv kernel on `stream`, and returns the first launch error (0 =
// launched).
extern "C" int t2p_flash_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* out,
                                 const void* lse, void* delta,
                                 const void* mask, void* dq, void* dk,
                                 void* dv, int B, int H, int Tq, int Tk,
                                 int D, float scale, void* stream) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, dout, out, dq, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  const unsigned char* mf = static_cast<const unsigned char*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TfBwdPlan wq{}, wkv{};
  if (plan_bwd_tf(wq, B, H, Tq, Tk, D, false) &&
      plan_bwd_tf(wkv, B, H, Tk, Tq, D, true)) {
    const int bh = B * H;
    CUtensorMap mq, mdo, mk, mv, mq_t, mdo_t, mk_t, mv_t;
    if (!tensor_map(&mq, q, bh, Tq, D, WG_ROWS, F32_BOX, 4) ||
        !tensor_map(&mdo, dout, bh, Tq, D, WG_ROWS, F32_BOX, 4) ||
        !tensor_map(&mk_t, k, bh, Tk, D, wq.tile, F32_BOX, 4) ||
        !tensor_map(&mv_t, v, bh, Tk, D, wq.tile, F32_BOX, 4) ||
        !tensor_map(&mk, k, bh, Tk, D, WG_ROWS, F32_BOX, 4) ||
        !tensor_map(&mv, v, bh, Tk, D, WG_ROWS, F32_BOX, 4) ||
        !tensor_map(&mq_t, q, bh, Tq, D, wkv.tile, F32_BOX, 4) ||
        !tensor_map(&mdo_t, dout, bh, Tq, D, wkv.tile, F32_BOX, 4))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare_tf(wq, wkv);
    if (err != cudaSuccess) return (int)err;
    err = launch_tf(TF_DQ_KERNELS[wq.idx], wq, s, mq, mdo, mk_t, mv_t, gf,
                    static_cast<const float*>(out), lf, df, mf,
                    static_cast<float*>(dq), H, Tq, Tk, D, wq.cb, wq.kc,
                    wq.vc, wq.nst, wq.ncl, scale);
    if (err != cudaSuccess) return (int)err;
    err = launch_tf(TF_DKDV_KERNELS[wkv.idx], wkv, s, mk, mv, mq_t, mdo_t, lf,
                    df, mf,
                    static_cast<float*>(dk), static_cast<float*>(dv), H, Tq,
                    Tk, D, wkv.cb, wkv.kc, wkv.vc, wkv.nst, wkv.ncl, scale);
    return (int)err;
  }
  const BwdPlan pq = plan_bwd(B, H, Tq, Tk, D);
  const BwdPlan pkv = plan_bwd(B, H, Tk, Tq, D);
  cudaError_t err = prepare(pq, pkv);
  if (err != cudaSuccess) return (int)err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  DQ_KERNEL<<<pq.grid, NT, pq.smem, s>>>(
      qf, kf, vf, gf, static_cast<const float*>(out), lf, df, mf,
      static_cast<float*>(dq), H, Tq, Tk, D, pq.dc, pq.t, pq.stages, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  DKDV_KERNEL<<<pkv.grid, NT, pkv.smem, s>>>(
      qf, kf, vf, gf, lf, df, mf, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Tq, Tk, D, pkv.dc, pkv.t, pkv.stages,
      scale);
  return (int)cudaGetLastError();
}

// The launch plans of a call, for reports: out = {dq: inner tile rows,
// stages, column chunks (blocks of a row tile, each computing S and dP),
// blocks, dynamic shared bytes, blocks per SM, threads per block, narrow
// (D <= 64), wgmma (1: TF32 wgmma; 0: the mma.sync kernels of D > 512), D
// boxes a product step, blocks of a cluster, clusters the device holds at
// once (-1 where not computed)}; then the same twelve for dkdv.
extern "C" int t2p_flash_bwd_plan(int B, int H, int Tq, int Tk, int D,
                                  int* out) {
  if (!valid_shape(B, H, Tq, Tk, D)) return (int)cudaErrorInvalidValue;
  TfBwdPlan w[2] = {};
  if (plan_bwd_tf(w[0], B, H, Tq, Tk, D, false) &&
      plan_bwd_tf(w[1], B, H, Tk, Tq, D, true)) {
    const bool ready = prepare_tf(w[0], w[1]) == cudaSuccess;
    for (int i = 0; i < 2; ++i) {
      const TfBwdPlan& p = w[i];
      int per_sm = -1, clusters = -1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = p.grid;
      cfg.blockDim = dim3(128, 1, 1);
      cfg.dynamicSmemBytes = p.smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)p.ncl;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (!ready ||
          (i == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, TF_DQ_KERNELS[p.idx], 128, p.smem)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, TF_DKDV_KERNELS[p.idx], 128, p.smem)) !=
              cudaSuccess)
        per_sm = -1;
      if (!ready ||
          (i == 0 ? cudaOccupancyMaxActiveClusters(
                        &clusters, TF_DQ_KERNELS[p.idx], &cfg)
                  : cudaOccupancyMaxActiveClusters(
                        &clusters, TF_DKDV_KERNELS[p.idx], &cfg)) !=
              cudaSuccess)
        clusters = -1;
      const int v[12] = {p.tile,
                         p.nst,
                         p.nz * p.ncl,
                         (int)(p.grid.x * p.grid.y * p.grid.z),
                         (int)p.smem,
                         per_sm,
                         128,
                         f32_boxes(D) <= 2,
                         1,
                         p.kc,
                         p.ncl,
                         clusters};
      for (int j = 0; j < 12; ++j) out[12 * i + j] = v[j];
    }
    return 0;
  }
  const BwdPlan plans[2] = {plan_bwd(B, H, Tq, Tk, D),
                            plan_bwd(B, H, Tk, Tq, D)};
  const bool ready = prepare(plans[0], plans[1]) == cudaSuccess;
  for (int i = 0; i < 2; ++i) {
    const BwdPlan& p = plans[i];
    int per_sm = -1;
    if (!ready ||
        (i == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, DQ_KERNEL, NT, p.smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, DKDV_KERNEL, NT, p.smem)) != cudaSuccess)
      per_sm = -1;
    const int v[12] = {p.t, p.stages, p.nchunk,
                       (int)(p.grid.x * p.grid.y * p.grid.z), (int)p.smem,
                       per_sm, NT, 0, 0, 0, 1, -1};
    for (int j = 0; j < 12; ++j) out[12 * i + j] = v[j];
  }
  return 0;
}
