// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// text2protein_tpu/ops/flash.py (reached through `flash_attention_fwd`).
// Same function: blockwise online-softmax attention over q (B,H,Tq,D) and
// k, v (B,H,Tk,D) with an optional (B,Tk) key mask applied as a -1e30 bias
// and p *= mask, so a fully masked row gives 0; accumulation in f32,
// out /= max(l, 1e-30), and lse = m + log(max(l, 1e-30)) per row.
//
// What bounds it on the card: at the shapes of the L=128 serving path
// (T <= 256, H*D = 256) one call moves at most 4 MiB and does at most
// 2.7e8 f32 multiply-adds, so the least time is a few microseconds and is
// set by the f32 operations, not the bytes; launch latency is of the same
// order. The design keeps every score in shared memory (nothing of the
// (Tq,Tk) logits goes to device memory, the only point of a flash kernel),
// reads q once per block and k, v once per (block, key tile), and spreads
// the work over B*H*ceil(Tq/16) blocks so the 16x16 grid fills the SMs.
// It is the simple kernel: CUDA-core FMAs, no wgmma and no TMA.
//
// Layout of one block (NT threads, BQ query rows, key tiles of BK rows):
//   shared: q tile (BQ x D, pre-scaled), k tile (BK x D+1, padded so the
//   score loop reads distinct banks), v tile (BK x D), scores/probabilities
//   (BQ x BK), the key mask of the tile, and per-row m, l, alpha.
//   registers: each thread owns ACC output elements of the BQ x D tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int ACC>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
    int D, int BK, float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* sq = smem;              // BQ x D
  float* sk = sq + BQ * D;       // BK x ks
  float* sv = sk + BK * ks;      // BK x D
  float* sp = sv + BK * D;       // BQ x BK
  float* smask = sp + BQ * BK;   // BK
  float* sm = smask + BK;        // BQ
  float* sl = sm + BQ;           // BQ
  float* salpha = sl + BQ;       // BQ

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const float* mb = mask ? mask + (size_t)(bh / H) * Tk : nullptr;

  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D;
    sq[e] = (q0 + i < Tq) ? qb[(size_t)q0 * D + e] * scale : 0.f;
  }
  if (tid < BQ) {
    sm[tid] = -1e30f;
    sl[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D;
      const int d = e - j * D;
      const bool in = k0 + j < Tk;
      const size_t g = (size_t)k0 * D + e;
      sk[j * ks + d] = in ? kb[g] : 0.f;
      sv[e] = in ? vb[g] : 0.f;
    }
    // 1 = attend. Keys past Tk (a ragged last tile) are dropped like
    // masked keys: bias -1e30 and p = 0.
    for (int j = tid; j < BK; j += NT)
      smask[j] = (k0 + j < Tk) ? (mb ? mb[k0 + j] : 1.f) : 0.f;
    __syncthreads();

    for (int e = tid; e < BQ * BK; e += NT) {
      const int i = e / BK;
      const int j = e - i * BK;
      const float* qi = sq + i * D;
      const float* kj = sk + j * ks;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      sp[e] = s + (smask[j] - 1.f) * 1e30f;
    }
    __syncthreads();

    for (int i = warp; i < BQ; i += NWARP) {
      float* row = sp + i * BK;
      float mx = -1e30f;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = sm[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(row[j] - m_new) * smask[j];
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[i] = alpha;
        sl[i] = sl[i] * alpha + sum;
        sm[i] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int e = tid + a * NT;
      if (e < BQ * D) {
        const int i = e / D;
        const int d = e - i * D;
        const float* pi = sp + i * BK;
        float o = acc[a] * salpha[i];
        for (int j = 0; j < BK; ++j) o = fmaf(pi[j], sv[j * D + d], o);
        acc[a] = o;
      }
    }
  }
  __syncthreads();

  float* ob = out + (size_t)bh * Tq * D;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * NT;
    if (e < BQ * D) {
      const int i = e / D;
      if (q0 + i < Tq) ob[(size_t)q0 * D + e] = acc[a] / fmaxf(sl[i], 1e-30f);
    }
  }
  if (tid < BQ && q0 + tid < Tq)
    lse[(size_t)bh * Tq + q0 + tid] = sm[tid] + logf(fmaxf(sl[tid], 1e-30f));
}

template <int ACC>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* mask, float* out, float* lse, int B, int H,
                   int Tq, int Tk, int D, int BK, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D +
                       (size_t)BQ * BK + BK + 3 * BQ);
  // Above 48 KB a block needs the opt-in; raise it to the largest size this
  // instantiation has been asked for (a host-side CUDA API call, made only
  // when the size grows).
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<ACC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_f32_kernel<ACC><<<grid, NT, smem, stream>>>(
      q, k, v, mask, out, lse, H, Tq, Tk, D, BK, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B,H,Tq,D), k, v: (B,H,Tk,D), out: (B,H,Tq,D), lse: (B*H,Tq) float32,
// all contiguous on the device; mask: (B,Tk) float32 (1 = attend) or null.
// D is a multiple of 8 and at most 1024. Launches on `stream` and returns
// the launch's error code (0 = launched).
extern "C" int t2p_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, void* lse, int B,
                                 int H, int Tq, int Tk, int D, float scale,
                                 void* stream) {
  if (D <= 0 || D % 8 != 0 || D > 1024 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0)
    return (int)cudaErrorInvalidValue;
  // Key tile: 64 rows at D <= 128, fewer at larger D, so that the k and v
  // tiles take at most 2 * 8192 floats of shared memory.
  int BK = 8192 / D;
  BK = BK > 64 ? 64 : (BK < 8 ? 8 : BK);
  const int need = (BQ * D + NT - 1) / NT;  // output elements per thread
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* mf = static_cast<const float*>(mask);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (need <= 1)
    err = launch<1>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  else if (need <= 2)
    err = launch<2>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  else if (need <= 4)
    err = launch<4>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  else if (need <= 8)
    err = launch<8>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  else if (need <= 16)
    err = launch<16>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  else if (need <= 32)
    err = launch<32>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  else
    err = launch<64>(qf, kf, vf, mf, of, lf, B, H, Tq, Tk, D, BK, scale, s);
  return (int)err;
}
