// Flash-attention backward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel `_flash_bwd_kernel` of
// text2protein_tpu/ops/flash.py (reached through `flash_attention_bwd`).
// Same function, per batch*head, from the forward's residuals (out, lse):
//   S  = (q k^T) * scale + (mask - 1) * 1e30     (bias BEFORE the exp)
//   P  = exp(S - lse)                             (no P *= mask afterwards)
//   dV = P^T dO
//   dS = P * (dO v^T - delta) * scale,  delta = rowsum(dO * out)
//   dQ = dS k,   dK = dS^T q
// delta is computed by the caller (the JAX package computes it outside its
// Pallas kernel too). A fully masked row has lse ~ -1e30 from the forward,
// so P = exp(0) = 1 on every key of that row, exactly as in the JAX kernel.
//
// Design. The TPU kernel holds the whole (Tq, Tk) block of one batch*head
// in VMEM and does five matmuls on it. Here that block never exists:
// two kernels tile it FA2-style and recompute P from lse inside each tile.
//   * dkdv: one block per (batch*head, key tile of T rows). It keeps its
//     k and v rows in shared memory and its dK, dV rows in registers, and
//     loops over query tiles of T rows (q, dO, lse, delta), so dK and dV
//     are summed in a fixed order with no atomics.
//   * dq:   one block per (batch*head, query tile of T rows). It keeps q, dO
//     in shared memory and dQ in registers, and loops over key tiles.
// S and dP are thus computed twice (once per kernel); in exchange every
// output element has one owner and the sums are deterministic.
// T = 64 rows at D <= 128 and fewer at larger D (T * D <= 8192), so D up
// to 1024 fits in shared memory and each thread owns at most 32 elements
// of each accumulator. Rows are padded to D + 1 floats so that the score
// loop (key row per lane) reads distinct banks.
//
// What bounds it on the card: at the L=128 training shapes (B=16, T <= 256,
// H*D = 256) one call moves at most ~21 MB and does at most 2.7 GFLOP of
// f32, so the least time is tens of microseconds, set by the f32 operations
// (10 * B*H*Tq*Tk*D at 67 TFLOP/s). This simple kernel runs on the CUDA
// cores with both operands of each FMA read from shared memory, so it is
// bound by shared-memory reads, well above that bound; wgmma and TMA come
// in a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;

// Shared-memory floats of the two kernels for tile T, head dim D.
__host__ __device__ inline size_t smem_dkdv(int T, int D) {
  return 4 * (size_t)T * (D + 1) + 2 * (size_t)T * T + 4 * (size_t)T;
}
__host__ __device__ inline size_t smem_dq(int T, int D) {
  return 4 * (size_t)T * (D + 1) + (size_t)T * T + 4 * (size_t)T;
}

// Loads `rows` rows of a (., D) matrix starting at row r0 into a padded
// shared tile (row stride D + 1); rows at or past `limit` read as 0.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows, int limit, int D) {
  const int ld = D + 1;
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r * ld + d] = (r0 + r < limit) ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

// The key-side vectors of a tile: the additive mask bias and whether the
// key exists (keys past Tk in a ragged last tile get P = 0 and dS = 0).
__device__ __forceinline__ void load_keys(float* bias, float* valid,
                                          const float* mb, int k0, int T,
                                          int Tk) {
  for (int j = threadIdx.x; j < T; j += NT) {
    const bool in = k0 + j < Tk;
    valid[j] = in ? 1.f : 0.f;
    bias[j] = (in && mb) ? (mb[k0 + j] - 1.f) * 1e30f : 0.f;
  }
}

// The query-side vectors of a tile: lse and delta, 0 past Tq.
__device__ __forceinline__ void load_queries(float* slse, float* sdelta,
                                             const float* lse,
                                             const float* delta, int q0,
                                             int T, int Tq) {
  for (int i = threadIdx.x; i < T; i += NT) {
    const bool in = q0 + i < Tq;
    slse[i] = in ? lse[q0 + i] : 0.f;
    sdelta[i] = in ? delta[q0 + i] : 0.f;
  }
}

// P and dS of one (query tile, key tile) pair, element e = i * T + j.
__device__ __forceinline__ void p_and_ds(
    int e, int T, int D, const float* sq, const float* sdo, const float* sk,
    const float* sv, const float* bias, const float* valid, const float* slse,
    const float* sdelta, bool row_in, float scale, float* p_out,
    float* ds_out) {
  const int ld = D + 1;
  const int i = e / T;
  const int j = e - i * T;
  const float* qi = sq + i * ld;
  const float* doi = sdo + i * ld;
  const float* kj = sk + j * ld;
  const float* vj = sv + j * ld;
  float s = 0.f, dp = 0.f;
  for (int d = 0; d < D; ++d) {
    s = fmaf(qi[d], kj[d], s);
    dp = fmaf(doi[d], vj[d], dp);
  }
  float p = 0.f, ds = 0.f;
  if (row_in && valid[j] != 0.f) {
    s = s * scale + bias[j];
    p = expf(s - slse[i]);
    ds = p * (dp - sdelta[i]) * scale;
  }
  *p_out = p;
  *ds_out = ds;
}

template <int ACC>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Tq, int Tk, int D, int T,
    float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sk = smem;             // T x ld
  float* sv = sk + T * ld;      // T x ld
  float* sq = sv + T * ld;      // T x ld
  float* sdo = sq + T * ld;     // T x ld
  float* sp = sdo + T * ld;     // T x T  (P, query-major)
  float* sds = sp + T * T;      // T x T  (dS)
  float* bias = sds + T * T;    // T
  float* valid = bias + T;      // T
  float* slse = valid + T;      // T
  float* sdelta = slse + T;     // T

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * T;
  const int tid = threadIdx.x;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;
  const float* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;

  load_rows(sk, k + koff, k0, T, Tk, D);
  load_rows(sv, v + koff, k0, T, Tk, D);
  load_keys(bias, valid, mb, k0, T, Tk);

  float acc_k[ACC], acc_v[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc_k[a] = acc_v[a] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += T) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(sq, q + qoff, q0, T, Tq, D);
    load_rows(sdo, dout + qoff, q0, T, Tq, D);
    load_queries(slse, sdelta, lse + (size_t)bh * Tq,
                 delta + (size_t)bh * Tq, q0, T, Tq);
    __syncthreads();

    for (int e = tid; e < T * T; e += NT)
      p_and_ds(e, T, D, sq, sdo, sk, sv, bias, valid, slse, sdelta,
               q0 + e / T < Tq, scale, &sp[e], &sds[e]);
    __syncthreads();

    // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] q[i]
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = tid + a * NT;
      if (e < T * D) {
        const int j = e / D;
        const int d = e - j * D;
        float ov = acc_v[a], ok = acc_k[a];
        for (int i = 0; i < T; ++i) {
          ov = fmaf(sp[i * T + j], sdo[i * ld + d], ov);
          ok = fmaf(sds[i * T + j], sq[i * ld + d], ok);
        }
        acc_v[a] = ov;
        acc_k[a] = ok;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * NT;
    if (e < T * D && k0 + e / D < Tk) {
      const size_t g = koff + (size_t)k0 * D + e;
      dk[g] = acc_k[a];
      dv[g] = acc_v[a];
    }
  }
}

template <int ACC>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dq, int H, int Tq,
    int Tk, int D, int T, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sq = smem;             // T x ld
  float* sdo = sq + T * ld;     // T x ld
  float* sk = sdo + T * ld;     // T x ld
  float* sv = sk + T * ld;      // T x ld
  float* sds = sv + T * ld;     // T x T
  float* bias = sds + T * T;    // T
  float* valid = bias + T;      // T
  float* slse = valid + T;      // T
  float* sdelta = slse + T;     // T

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * T;
  const int tid = threadIdx.x;
  const size_t qoff = (size_t)bh * Tq * D;
  const size_t koff = (size_t)bh * Tk * D;
  const float* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;

  load_rows(sq, q + qoff, q0, T, Tq, D);
  load_rows(sdo, dout + qoff, q0, T, Tq, D);
  load_queries(slse, sdelta, lse + (size_t)bh * Tq, delta + (size_t)bh * Tq,
               q0, T, Tq);

  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += T) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(sk, k + koff, k0, T, Tk, D);
    load_rows(sv, v + koff, k0, T, Tk, D);
    load_keys(bias, valid, mb, k0, T, Tk);
    __syncthreads();

    for (int e = tid; e < T * T; e += NT) {
      float p;
      p_and_ds(e, T, D, sq, sdo, sk, sv, bias, valid, slse, sdelta,
               q0 + e / T < Tq, scale, &p, &sds[e]);
    }
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] k[j]
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = tid + a * NT;
      if (e < T * D) {
        const int i = e / D;
        const int d = e - i * D;
        const float* dsi = sds + i * T;
        float o = acc[a];
        for (int j = 0; j < T; ++j) o = fmaf(dsi[j], sk[j * ld + d], o);
        acc[a] = o;
      }
    }
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * NT;
    if (e < T * D && q0 + e / D < Tq) dq[qoff + (size_t)q0 * D + e] = acc[a];
  }
}

// Above 48 KB a block needs the opt-in; raise it to the largest size each
// kernel has been asked for (a host-side call, made only when it grows).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, size_t* opted) {
  if (bytes <= *opted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *opted = bytes;
  return err;
}

template <int ACC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   const float* mask, float* dq, float* dk, float* dv, int B,
                   int H, int Tq, int Tk, int D, int T, float scale,
                   cudaStream_t stream) {
  static size_t opted_dkdv = 48 * 1024, opted_dq = 48 * 1024;
  const size_t b_dkdv = sizeof(float) * smem_dkdv(T, D);
  const size_t b_dq = sizeof(float) * smem_dq(T, D);
  cudaError_t err = opt_in(flash_bwd_dkdv_kernel<ACC>, b_dkdv, &opted_dkdv);
  if (err != cudaSuccess) return err;
  err = opt_in(flash_bwd_dq_kernel<ACC>, b_dq, &opted_dq);
  if (err != cudaSuccess) return err;
  const dim3 grid_k(B * H, (Tk + T - 1) / T);
  flash_bwd_dkdv_kernel<ACC><<<grid_k, NT, b_dkdv, stream>>>(
      q, k, v, dout, lse, delta, mask, dk, dv, H, Tq, Tk, D, T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(B * H, (Tq + T - 1) / T);
  flash_bwd_dq_kernel<ACC><<<grid_q, NT, b_dq, stream>>>(
      q, k, v, dout, lse, delta, mask, dq, H, Tq, Tk, D, T, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: (B,H,Tq,D); k, v, dk, dv: (B,H,Tk,D); lse, delta: (B*H,Tq);
// all float32, contiguous, on the device; mask: (B,Tk) float32 (1 = attend)
// or null. D is a multiple of 8 and at most 1024. Launches both kernels on
// `stream` and returns the first launch error (0 = launched).
extern "C" int t2p_flash_bwd_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* mask,
                                 void* dq, void* dk, void* dv, int B, int H,
                                 int Tq, int Tk, int D, float scale,
                                 void* stream) {
  if (D <= 0 || D % 8 != 0 || D > 1024 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0)
    return (int)cudaErrorInvalidValue;
  // Tile rows: a multiple of 8 in [8, 64] with T * D <= 8192.
  int T = (8192 / D) / 8 * 8;
  T = T > 64 ? 64 : (T < 8 ? 8 : T);
  const int need = (T * D + NT - 1) / NT;  // accumulator elements per thread
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  const float* mf = static_cast<const float*>(mask);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define T2P_LAUNCH(N)                                                      \
  launch<N>(qf, kf, vf, of, lf, df, mf, dqf, dkf, dvf, B, H, Tq, Tk, D, T, \
            scale, s)
  cudaError_t err;
  if (need <= 1)
    err = T2P_LAUNCH(1);
  else if (need <= 2)
    err = T2P_LAUNCH(2);
  else if (need <= 4)
    err = T2P_LAUNCH(4);
  else if (need <= 8)
    err = T2P_LAUNCH(8);
  else if (need <= 16)
    err = T2P_LAUNCH(16);
  else
    err = T2P_LAUNCH(32);
#undef T2P_LAUNCH
  return (int)err;
}
