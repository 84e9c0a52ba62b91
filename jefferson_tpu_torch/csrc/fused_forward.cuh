// Pieces shared by the port's fused render steps (fused_step_onehot.cu and
// fused_step_gather.cu): launch A, the in-kernel forward DFT and distance
// cue, and the tail-IDFT inner loop of launch B.
//
// Launch A (forward_distance) replaces the TPU kernels' shared forward,
// jefferson_tpu/pallas/fused_step.py _forward_planes (:273) with
// _select_distance (:163) and _distance_planes (:259).  Per output row
// r = s*nb + b (source s, block b) it computes
//
//   X[r]  = sum_{m<8} tw[m] * P[s, b+m],  P = 128-sample sub-block DFTs
//   XD[r] = X[r] * D(u_hi, u_lo, inv_frac)
//
// One CTA per (32 blocks, 64 bins, source): the sub-block samples and a
// (128 x 64) slice of the DFT basis sit in shared memory, the twiddle sum
// and the distance multiply run on the CTA's P tile, and XD goes to a
// scratch buffer (rows x 513 x 2 floats) that launch B reads.  Every form
// runs this one launch, so the forward is bit-identical between them.
//
// Numerics: every product whose rounding the JAX op order fixes (twiddle
// sum, distance planes with the 12-bit phase split, complex multiplies) is
// written with __fmul_rn/__fadd_rn/__fsub_rn so FMA contraction cannot
// move it; only the DFT dot products accumulate with fmaf, in fp32, in
// another order than XLA's (~1e-7 relative).  cosf/sinf are the precise
// library functions: build without fast math.

#pragma once

#include <cuda_runtime.h>

#include "entry.cuh"

namespace {

constexpr int FPB = 128;        // samples per block = sub-block length
constexpr int Q = 8;            // sub-blocks per 1024-sample window
constexpr int BINS = 513;       // half-spectrum of the 1024-point DFT
constexpr int C4 = 4 * BINS;    // combined filter row [rL | iL | rR | iR]

// ---- launch A: sub-block DFT, twiddle sum, distance multiply -------------
constexpr int A_BT = 32;                // output blocks per CTA
constexpr int A_KT = 64;                // bins per CTA
constexpr int A_THREADS = 256;          // 64 columns x 4 row groups
constexpr int A_ROWS = 40;              // A_BT + Q - 1 = 39 sub-blocks, padded
constexpr int A_ROWS_PER_THREAD = A_ROWS / (A_THREADS / A_KT);   // 10
constexpr int A_OUT_PER_THREAD = A_BT / (A_THREADS / A_KT);      // 8
constexpr size_t A_SMEM =
    sizeof(float) * (A_ROWS * FPB + 2 * FPB * A_KT + 2 * A_ROWS * A_KT);

// ---- launch B's tail IDFT: 32-bin K chunks, 8 x 8 register tiles ---------
constexpr int T_KC = 32;                // bins per K chunk
constexpr int T_QS = T_KC + 1;          // padded row stride of a q chunk

// Distance plane at bin k: cos/-sin(2π·frac(frac(u_hi·k) + u_lo·k))·inv_frac,
// in the op order of ops/filters.distance_factors_split.  u_hi·k is exact
// (12-bit head), so each step must round on its own.
__device__ __forceinline__ void distance_plane(float uh, float ul, float fr, float kf,
                                               float* dr, float* di) {
  float head = __fmul_rn(uh, kf);
  head = __fsub_rn(head, floorf(head));
  float cyc = __fadd_rn(head, __fmul_rn(ul, kf));
  cyc = __fsub_rn(cyc, floorf(cyc));
  const float arg = __fmul_rn(6.283185307179586f, cyc);
  *dr = __fmul_rn(cosf(arg), fr);
  *di = __fmul_rn(-sinf(arg), fr);
}

// Complex multiply (a * b) with each product rounded on its own.
__device__ __forceinline__ void cmul_rn(float ar, float ai, float br, float bi,
                                        float* re, float* im) {
  *re = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  *im = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

__global__ void __launch_bounds__(A_THREADS)
forward_distance(const float* __restrict__ streams, int nb,
                 const float* __restrict__ uh, const float* __restrict__ ul,
                 const float* __restrict__ fr, const int* __restrict__ dsel, int n_dist,
                 const float* __restrict__ cfr, const float* __restrict__ cfi,
                 const float* __restrict__ twr, const float* __restrict__ twi,
                 float* __restrict__ xdr, float* __restrict__ xdi) {
  extern __shared__ float smem[];
  float* subs = smem;                       // [A_ROWS][FPB]
  float* bre = subs + A_ROWS * FPB;         // [FPB][A_KT]
  float* bim = bre + FPB * A_KT;
  float* pre = bim + FPB * A_KT;            // [A_ROWS][A_KT]
  float* pim = pre + A_ROWS * A_KT;

  const int b0 = blockIdx.x * A_BT;
  const int k0 = blockIdx.y * A_KT;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int nbt = min(A_BT, nb - b0);       // output blocks of this tile
  const int nsub = nbt + Q - 1;             // sub-blocks it reads

  // sub-blocks [b0, b0 + nsub) of source s are contiguous samples
  const float* src = streams + (size_t)s * (nb + Q - 1) * FPB + (size_t)b0 * FPB;
  for (int i = tid; i < A_ROWS * FPB; i += A_THREADS)
    subs[i] = i < nsub * FPB ? src[i] : 0.f;
  for (int i = tid; i < FPB * A_KT; i += A_THREADS) {
    const int n = i / A_KT, k = k0 + i % A_KT;
    bre[i] = k < BINS ? cfr[n * BINS + k] : 0.f;
    bim[i] = k < BINS ? cfi[n * BINS + k] : 0.f;
  }
  __syncthreads();

  // P = subs @ basis slice: thread owns column c, rows rg*10 .. rg*10+9
  const int c = tid % A_KT;
  const int rg = tid / A_KT;
  float acc_r[A_ROWS_PER_THREAD], acc_i[A_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) acc_r[i] = acc_i[i] = 0.f;
  for (int n = 0; n < FPB; ++n) {
    const float br = bre[n * A_KT + c], bi = bim[n * A_KT + c];
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
      const float x = subs[(rg * A_ROWS_PER_THREAD + i) * FPB + n];
      acc_r[i] = fmaf(x, br, acc_r[i]);
      acc_i[i] = fmaf(x, bi, acc_i[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    pre[(rg * A_ROWS_PER_THREAD + i) * A_KT + c] = acc_r[i];
    pim[(rg * A_ROWS_PER_THREAD + i) * A_KT + c] = acc_i[i];
  }
  __syncthreads();

  const int k = k0 + c;
  if (k >= BINS) return;
  float tr[Q], ti[Q];
#pragma unroll
  for (int m = 1; m < Q; ++m) {
    tr[m] = twr[m * BINS + k];
    ti[m] = twi[m * BINS + k];
  }
  const float kf = (float)k;
  for (int j = 0; j < A_OUT_PER_THREAD; ++j) {
    const int b = rg * A_OUT_PER_THREAD + j;
    if (b >= nbt) break;
    // X[b] = P[b] + sum_{m=1..7} tw[m] * P[b+m], m ascending (JAX order)
    float xr = pre[b * A_KT + c], xi = pim[b * A_KT + c];
#pragma unroll
    for (int m = 1; m < Q; ++m) {
      const float pr = pre[(b + m) * A_KT + c], pi = pim[(b + m) * A_KT + c];
      xr = __fadd_rn(xr, __fsub_rn(__fmul_rn(tr[m], pr), __fmul_rn(ti[m], pi)));
      xi = __fadd_rn(xi, __fadd_rn(__fmul_rn(tr[m], pi), __fmul_rn(ti[m], pr)));
    }
    const int row = s * nb + b0 + b;
    int t = row;
    if (dsel) {  // a selector outside 1..n_dist-1 takes triple 0, as on the TPU
      t = dsel[row];
      t = t > 0 && t < n_dist ? t : 0;
    }
    float dr, di;
    distance_plane(uh[t], ul[t], fr[t], kf, &dr, &di);
    cmul_rn(xr, xi, dr, di, &xdr[(size_t)row * BINS + k], &xdi[(size_t)row * BINS + k]);
  }
}

// Launch A over num_sources streams of nb blocks each (rows = num_sources*nb).
inline cudaError_t launch_forward_distance(
    cudaStream_t stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi) {
  cudaError_t err = cudaFuncSetAttribute(
      forward_distance, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)A_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((nb + A_BT - 1) / A_BT, (BINS + A_KT - 1) / A_KT, num_sources);
  forward_distance<<<grid, A_THREADS, A_SMEM, stream>>>(
      streams, nb, uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
  return cudaGetLastError();
}

// Stage the (T_KC x FPB) tail-basis chunk that starts at bin k0.
__device__ __forceinline__ void load_tail_basis(float* br, float* bi,
                                                const float* __restrict__ icr,
                                                const float* __restrict__ ici,
                                                int k0, int tid, int nthreads) {
  for (int i = tid; i < T_KC * FPB; i += nthreads) {
    const int k = k0 + i / FPB;
    br[i] = k < BINS ? icr[(size_t)k0 * FPB + i] : 0.f;
    bi[i] = k < BINS ? ici[(size_t)k0 * FPB + i] : 0.f;
  }
}

// acc[i][j] += sum over the chunk's bins of qr*br + qi*bi for operand row
// ty*8+i and output column tx+16*j, bins in ascending order: each output
// element accumulates the same sequence whatever the operand's height.
__device__ __forceinline__ void tail_chunk_fma(float (&acc)[8][8], const float* qr,
                                               const float* qi, const float* br,
                                               const float* bi, int tx, int ty) {
  for (int kk = 0; kk < T_KC; ++kk) {
    float ar[8], ai[8], vr[8], vi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ar[i] = qr[(ty * 8 + i) * T_QS + kk];
      ai[i] = qi[(ty * 8 + i) * T_QS + kk];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vr[j] = br[kk * FPB + tx + 16 * j];
      vi[j] = bi[kk * FPB + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = fmaf(ar[i], vr[j], acc[i][j]);
        acc[i][j] = fmaf(ai[i], vi[j], acc[i][j]);
      }
  }
}

// The blocked tail: the K chunks of each 128-bin block accumulate into
// ``part``, which is then added to ``acc`` and cleared, so each output sums
// five block partials in order instead of one 1026-term chain, whose
// rounding error grows with its length.  The JAX package's tail_tree
// contraction cuts K at the same 128-bin boundaries (pallas/fused_step.py
// _tail_dots :195) for the same reason.
constexpr int T_BLOCK = 128;

__device__ __forceinline__ bool ends_tail_block(int k0) {
  return (k0 + T_KC) % T_BLOCK == 0 || k0 + T_KC >= BINS;
}

__device__ __forceinline__ void fold_tail_block(float (&acc)[8][8], float (&part)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
      part[i][j] = 0.f;
    }
}

}  // namespace
