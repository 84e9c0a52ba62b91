// Batched fused render step for Hopper (sm_90a): sliding forward DFT,
// distance cue, 4-bracket filter blend, tail IDFT and crossfade.
//
// Replaces the TPU kernel _onehot_kernel (jefferson_tpu/pallas/fused_step.py:347)
// as fused_step_onehot_xfade (:721) calls it with one shared compact table.
// Per output row r = s*nb + b (source s, block b) it computes
//
//   X[r]     = sum_{m<8} tw[m] * P[s, b+m],  P = 128-sample sub-block DFTs
//   XD[r]    = X[r] * D(u_hi, u_lo, inv_frac)           (distance planes)
//   G_old[r] = sum_j w[r,j] * T[ridx[r,j]]               (T: [rL|iL|rR|iR])
//   G_new[r] = G_old[r+1] within a source, else the blend of ridx_last[s]
//   y_side   = tail128(IDFT(XD * G_side)) per ear
//   out[r]   = y_old * (1 - n/127) + y_new * n/127   where xf[r] > 0, else y_new
//
// The TPU kernel's one-hot blend (a (rows, U) x (U, 2052) MXU product) is
// the same function as this weighted 4-row gather; the compact table
// (U_pad x 2052 floats, 1.05 MB at U_pad = 128) does not fit in shared
// memory, so it is read from global memory through L2.
//
// What bounds it: ~23 GFLOP per 256 x 64 step, all fp32 on the CUDA cores
// (TF32 tensor-core products would break the 1e-6 oracle gate), so the
// step is FMA-bound; the tail IDFT is 3/4 of the work.  Design, kept simple
// for a first port: two launches.
//   A (forward_distance): one CTA per (32 blocks, 64 bins, source).  The
//     sub-block samples and a (128 x 64) slice of the DFT basis sit in
//     shared memory; the twiddle sum and the distance multiply run on the
//     CTA's P tile; XD goes to a scratch buffer (B x 513 x 2 floats).
//   B (blend_tail_xfade): one CTA per 32 rows.  The four (side, ear)
//     products form a 128-row operand against the (513 x 128) tail basis,
//     tiled along K = 513 in 32-bin chunks through shared memory, with an
//     8 x 8 register tile per thread; the crossfade is the epilogue.
//
// Numerics: every product whose rounding the JAX op order fixes (twiddle
// sum, distance planes with the 12-bit phase split, blend, complex
// multiplies, crossfade) is written with __fmul_rn/__fadd_rn/__fsub_rn so
// FMA contraction cannot move it; only the two DFT dot products accumulate
// with fmaf, in fp32, in another order than XLA's (~1e-7 relative).
// cosf/sinf are the precise library functions: build without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int FPB = 128;        // samples per block = sub-block length
constexpr int Q = 8;            // sub-blocks per 1024-sample window
constexpr int BINS = 513;       // half-spectrum of the 1024-point DFT
constexpr int C4 = 4 * BINS;    // combined table row [rL | iL | rR | iR]

// ---- launch A: sub-block DFT, twiddle sum, distance multiply -------------
constexpr int A_BT = 32;                // output blocks per CTA
constexpr int A_KT = 64;                // bins per CTA
constexpr int A_THREADS = 256;          // 64 columns x 4 row groups
constexpr int A_ROWS = 40;              // A_BT + Q - 1 = 39 sub-blocks, padded
constexpr int A_ROWS_PER_THREAD = A_ROWS / (A_THREADS / A_KT);   // 10
constexpr int A_OUT_PER_THREAD = A_BT / (A_THREADS / A_KT);      // 8
constexpr size_t A_SMEM =
    sizeof(float) * (A_ROWS * FPB + 2 * FPB * A_KT + 2 * A_ROWS * A_KT);

// ---- launch B: blend, complex multiply, tail IDFT, crossfade -------------
constexpr int B_R = 32;                 // output rows per CTA
constexpr int B_KC = 32;                // bins per K chunk
constexpr int B_M = 4 * B_R;            // (side, ear, row) operand rows
constexpr int B_QS = B_KC + 1;          // padded row stride of the q chunk
constexpr int B_THREADS = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr size_t B_SMEM = sizeof(float) * (2 * B_M * B_QS + 2 * B_KC * FPB);
static_assert(B_M * FPB <= 2 * B_M * B_QS + 2 * B_KC * FPB,
              "epilogue tile must fit in the main-loop shared memory");
static_assert(B_THREADS == 2 * B_R * 4, "one thread per (side, row, bracket)");

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
    xdr[(size_t)row * BINS + k] = __fsub_rn(__fmul_rn(xr, dr), __fmul_rn(xi, di));
    xdi[(size_t)row * BINS + k] = __fadd_rn(__fmul_rn(xr, di), __fmul_rn(xi, dr));
  }
}

__global__ void __launch_bounds__(B_THREADS)
blend_tail_xfade(const float* __restrict__ xdr, const float* __restrict__ xdi,
                 int rows, int nb, const float* __restrict__ table, int u_rows,
                 const int* __restrict__ ridx, const float* __restrict__ w,
                 const int* __restrict__ ridx_last, const float* __restrict__ w_last,
                 const float* __restrict__ xf,
                 const float* __restrict__ icr, const float* __restrict__ ici,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* qr = smem;                 // [B_M][B_QS], m = (side*2 + ear)*B_R + row
  float* qi = qr + B_M * B_QS;
  float* br = qi + B_M * B_QS;      // [B_KC][FPB]
  float* bi = br + B_KC * FPB;
  float* y = smem;                  // epilogue [B_M][FPB], after the main loop
  __shared__ int sid[2][B_R][4];    // [side][row][bracket]: side 0 old, 1 new
  __shared__ float swt[2][B_R][4];

  const int r0 = blockIdx.x * B_R;
  const int tid = threadIdx.x;
  {
    // One (side, row, bracket) per thread.  Side 0 blends old row r; side 1
    // the new row, which is old row r+1 of the same source, or after a
    // source's last block its final new row.  An id outside the table
    // matches no one-hot column on the TPU, so it adds nothing: weight 0
    // on row 0.
    const int side = tid / (B_R * 4), row = tid / 4 % B_R, j = tid % 4, r = r0 + row;
    int id = 0;
    float wt = 0.f;
    if (r < rows) {
      if (side == 0 || r % nb + 1 < nb) {
        id = ridx[(r + side) * 4 + j];
        wt = w[(r + side) * 4 + j];
      } else {
        id = ridx_last[(r / nb) * 4 + j];
        wt = w_last[(r / nb) * 4 + j];
      }
    }
    const bool in_table = id >= 0 && id < u_rows;
    sid[side][row][j] = in_table ? id : 0;
    swt[side][row][j] = in_table ? wt : 0.f;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < BINS; k0 += B_KC) {
    // q chunk: for (row, bin) the blended rows of both sides, times XD
    for (int i = tid; i < B_R * B_KC; i += B_THREADS) {
      const int row = i / B_KC, kk = i % B_KC, k = k0 + kk, r = r0 + row;
      float q[2][2][2] = {};        // [side][ear][re, im]
      if (k < BINS && r < rows) {
        const float xr = xdr[(size_t)r * BINS + k], xi = xdi[(size_t)r * BINS + k];
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          float g[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float* trow = table + (size_t)sid[side][row][j] * C4 + k;
            const float wj = swt[side][row][j];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float v = __fmul_rn(wj, trow[p * BINS]);
              g[p] = j == 0 ? v : __fadd_rn(g[p], v);
            }
          }
#pragma unroll
          for (int ear = 0; ear < 2; ++ear) {
            const float gr = g[2 * ear], gi = g[2 * ear + 1];
            q[side][ear][0] = __fsub_rn(__fmul_rn(xr, gr), __fmul_rn(xi, gi));
            q[side][ear][1] = __fadd_rn(__fmul_rn(xr, gi), __fmul_rn(xi, gr));
          }
        }
      }
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int ear = 0; ear < 2; ++ear) {
          const int m = (side * 2 + ear) * B_R + row;
          qr[m * B_QS + kk] = q[side][ear][0];
          qi[m * B_QS + kk] = q[side][ear][1];
        }
    }
    for (int i = tid; i < B_KC * FPB; i += B_THREADS) {
      const int k = k0 + i / FPB;
      br[i] = k < BINS ? icr[(size_t)k0 * FPB + i] : 0.f;
      bi[i] = k < BINS ? ici[(size_t)k0 * FPB + i] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < B_KC; ++kk) {
      float ar[8], ai[8], vr[8], vi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ar[i] = qr[(ty * 8 + i) * B_QS + kk];
        ai[i] = qi[(ty * 8 + i) * B_QS + kk];
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
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) y[(ty * 8 + i) * FPB + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // crossfade epilogue: out[r] = [L 128 | R 128]
  for (int i = tid; i < B_R * 2 * FPB; i += B_THREADS) {
    const int row = i / (2 * FPB), col = i % (2 * FPB), r = r0 + row;
    if (r >= rows) break;
    const int ear = col / FPB, t = col % FPB;
    const float y_old = y[(ear * B_R + row) * FPB + t];
    const float y_new = y[((2 + ear) * B_R + row) * FPB + t];
    const float fn = (float)t / (float)(FPB - 1);
    const bool on = xf[r] > 0.f;
    const float a = on ? __fsub_rn(1.f, fn) : 0.f;
    const float b = on ? fn : 1.f;
    out[(size_t)r * 2 * FPB + col] = __fadd_rn(__fmul_rn(y_old, a), __fmul_rn(y_new, b));
  }
}

}  // namespace

// One fused step: launch A writes the XD planes to the caller's scratch
// (xdr, xdi: rows x 513 each), launch B writes out (rows x 256).  Every
// pointer is device memory; dsel is null for per-row distance (uh/ul/fr
// then have one entry per row), else it selects each row's triple among
// the first n_dist.  table has u_rows rows.  Launches on ``stream`` of
// ``device`` without synchronising, leaves the caller's current device as
// it was, and returns the first CUDA error (0 when both launches went).
extern "C" int jt_fused_step_onehot_xfade(
    int device, void* stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* table, int u_rows, const int* ridx, const float* w,
    const int* ridx_last, const float* w_last, const float* xf,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    const float* icr, const float* ici,
    float* xdr, float* xdi, float* out) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(forward_distance,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)A_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blend_tail_xfade,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_SMEM);
  if (err == cudaSuccess) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid_a((nb + A_BT - 1) / A_BT, (BINS + A_KT - 1) / A_KT, num_sources);
    forward_distance<<<grid_a, A_THREADS, A_SMEM, s>>>(
        streams, nb, uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const int rows = num_sources * nb;
    blend_tail_xfade<<<(rows + B_R - 1) / B_R, B_THREADS, B_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
        xdr, xdi, rows, nb, table, u_rows, ridx, w, ridx_last, w_last, xf, icr, ici, out);
    err = cudaGetLastError();
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

extern "C" const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
