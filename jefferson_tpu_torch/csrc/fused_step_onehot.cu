// One-hot fused render step for Hopper (sm_90a): sliding forward DFT,
// distance cue, 4-bracket filter blend from a compact table, tail IDFT and
// crossfade.
//
// Replaces the TPU kernel _onehot_kernel (jefferson_tpu/pallas/fused_step.py:347)
// in the three forms that call it:
//   row 1  fused_step_onehot_xfade (:721), S sources, one shared table;
//   row 3  fused_step_stream_onehot_xfade (:517), one stream;
//   row 4  fused_step_stream_onehot_grouped_xfade (:615), one stream whose
//          tiles blend against per-group tables.
// and, through jt_fused_spatializer_apply at the end of this file, the
// full-table kernel of pallas/fused_spatializer.py (row 8).
// They differ only in where a row's new filter comes from and which table
// rows it reads, so one launch B serves all three through two numbers:
//   seg         rows per boundary segment: the new row of r is old row r+1
//               inside a segment; the last row of a segment takes boundary
//               row r / seg (row 1: seg = nb with the per-source ridx_last;
//               row 3: seg = B with ridx_last; row 4: seg = tb with rbnd;
//               row 8: seg = 1, so bnd holds every row's new brackets);
//   group_rows  table rows are offset by (r / group_rows) * u_rows (rows 1,
//               3 and 8: one group; row 4: group_tiles * tb).
// Per output row r:
//
//   XD[r]    = launch A (fused_forward.cuh)
//   G_old[r] = sum_j w[r,j] * T[base(r) + ridx[r,j]]     (T: [rL|iL|rR|iR])
//   G_new[r] = G_old[r+1] inside a segment, else the blend of bnd[r / seg]
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
//   A (forward_distance, fused_forward.cuh): XD to a scratch buffer.
//   B (blend_tail_xfade): one CTA per 32 rows.  The four (side, ear)
//     products form a 128-row operand against the (513 x 128) tail basis,
//     tiled along K = 513 in 32-bin chunks through shared memory, with an
//     8 x 8 register tile per thread; the crossfade is the epilogue.  Rows
//     3 and 4 sum the tail by 128-bin blocks (the blocked tail,
//     fused_forward.cuh); row 1 keeps one chain over K, as it was first
//     measured (the blocked form's extra registers would halve its
//     occupancy at 512 CTAs).
//
// Numerics: the blend, complex multiplies and crossfade round each product
// on its own (__fmul_rn/__fadd_rn); only the tail dot products use fmaf.

#include "fused_forward.cuh"

namespace {

constexpr int B_R = 32;                 // output rows per CTA
constexpr int B_M = 4 * B_R;            // (side, ear, row) operand rows
constexpr int B_THREADS = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr size_t B_SMEM = sizeof(float) * (2 * B_M * T_QS + 2 * T_KC * FPB);
static_assert(B_M * FPB <= 2 * B_M * T_QS + 2 * T_KC * FPB,
              "epilogue tile must fit in the main-loop shared memory");
static_assert(B_THREADS == 2 * B_R * 4, "one thread per (side, row, bracket)");

template <bool BLOCKED>
__global__ void __launch_bounds__(B_THREADS)
blend_tail_xfade(const float* __restrict__ xdr, const float* __restrict__ xdi,
                 int rows, const float* __restrict__ table, int u_rows,
                 const int* __restrict__ ridx, const float* __restrict__ w,
                 const int* __restrict__ bnd_idx, const float* __restrict__ bnd_w,
                 int seg, int group_rows, const float* __restrict__ xf,
                 const float* __restrict__ icr, const float* __restrict__ ici,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* qr = smem;                 // [B_M][T_QS], m = (side*2 + ear)*B_R + row
  float* qi = qr + B_M * T_QS;
  float* br = qi + B_M * T_QS;      // [T_KC][FPB]
  float* bi = br + T_KC * FPB;
  float* y = smem;                  // epilogue [B_M][FPB], after the main loop
  __shared__ int sid[2][B_R][4];    // [side][row][bracket]: side 0 old, 1 new
  __shared__ float swt[2][B_R][4];

  const int r0 = blockIdx.x * B_R;
  const int tid = threadIdx.x;
  {
    // One (side, row, bracket) per thread.  Side 0 blends old row r; side 1
    // the new row, which is old row r+1 inside a segment, or the segment's
    // boundary row at its end.  Both read the table group of row r.  An id
    // outside the group's u_rows rows matches no one-hot column on the TPU,
    // so it adds nothing: weight 0 on row 0.
    const int side = tid / (B_R * 4), row = tid / 4 % B_R, j = tid % 4, r = r0 + row;
    int id = -1;
    float wt = 0.f;
    if (r < rows) {
      if (side == 0 || r % seg + 1 < seg) {
        id = ridx[(r + side) * 4 + j];
        wt = w[(r + side) * 4 + j];
      } else {
        id = bnd_idx[(r / seg) * 4 + j];
        wt = bnd_w[(r / seg) * 4 + j];
      }
    }
    const bool in_table = id >= 0 && id < u_rows;
    sid[side][row][j] = in_table ? (r / group_rows) * u_rows + id : 0;
    swt[side][row][j] = in_table ? wt : 0.f;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8], part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < BINS; k0 += T_KC) {
    // q chunk: for (row, bin) the blended rows of both sides, times XD
    for (int i = tid; i < B_R * T_KC; i += B_THREADS) {
      const int row = i / T_KC, kk = i % T_KC, k = k0 + kk, r = r0 + row;
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
          for (int ear = 0; ear < 2; ++ear)
            cmul_rn(xr, xi, g[2 * ear], g[2 * ear + 1], &q[side][ear][0], &q[side][ear][1]);
        }
      }
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int ear = 0; ear < 2; ++ear) {
          const int m = (side * 2 + ear) * B_R + row;
          qr[m * T_QS + kk] = q[side][ear][0];
          qi[m * T_QS + kk] = q[side][ear][1];
        }
    }
    load_tail_basis(br, bi, icr, ici, k0, tid, B_THREADS);
    __syncthreads();
    if (BLOCKED) {
      tail_chunk_fma(part, qr, qi, br, bi, tx, ty);
      if (ends_tail_block(k0)) fold_tail_block(acc, part);
    } else {
      tail_chunk_fma(acc, qr, qi, br, bi, tx, ty);
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

// One fused step.  Launch A runs the forward over num_sources streams of
// nb blocks each and writes the XD planes to the caller's scratch (xdr,
// xdi: rows x 513 each, rows = num_sources * nb); launch B writes out
// (rows x 256).  Every pointer is device memory; dsel is null for per-row
// distance (uh/ul/fr then have one entry per row), else it selects each
// row's triple among the first n_dist.  table holds u_rows rows per group
// of group_rows output rows; bnd_idx/bnd_w hold one row per seg output
// rows; blocked_tail != 0 sums the tail by 128-bin blocks.  Launches on
// ``stream`` of ``device`` without synchronising, leaves the caller's
// current device as it was, and returns the first CUDA error (0 when both
// launches went).
extern "C" int jt_fused_step_onehot_xfade(
    int device, void* stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* table, int u_rows, const int* ridx, const float* w,
    const int* bnd_idx, const float* bnd_w, int seg, int group_rows, int blocked_tail,
    const float* xf,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    const float* icr, const float* ici,
    float* xdr, float* xdi, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_forward_distance(s, streams, num_sources, nb, uh, ul, fr,
                                              dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
    auto kernel = blocked_tail ? blend_tail_xfade<true> : blend_tail_xfade<false>;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)B_SMEM);
    if (err != cudaSuccess) return err;
    const int rows = num_sources * nb;
    kernel<<<(rows + B_R - 1) / B_R, B_THREADS, B_SMEM, s>>>(
        xdr, xdi, rows, table, u_rows, ridx, w, bnd_idx, bnd_w, seg, group_rows, xf,
        icr, ici, out);
    return cudaGetLastError();
  });
}

// Row 8, the full-table blend-apply-tail step (jefferson_tpu/pallas/
// fused_spatializer.py _kernel :46 of fused_apply :102): launch B with
// seg = 1, so every row's old side blends idx_old[r] and its new side
// idx_new[r], both against the whole table (table_rows rows, one group), the
// blocked tail, and the crossfade where xf[r] > 0.  With streams null, xdr
// and xdi are the caller's XD planes (rows x 513); else launch A first
// writes them from one stream of rows blocks (streams: (rows + 7) x 128
// samples, history first) with per-row distance uh/ul/fr (rows each).  The
// live block step runs it at one row, the scan render at every row of a
// chunk.  Launches on ``stream`` of ``device`` without synchronising and
// returns the first CUDA error.
extern "C" int jt_fused_spatializer_apply(
    int device, void* stream, int rows,
    const float* streams, const float* uh, const float* ul, const float* fr,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi,
    const float* table, int table_rows, const int* idx_old, const float* w_old,
    const int* idx_new, const float* w_new, const float* xf,
    const float* icr, const float* ici, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (streams)
      err = launch_forward_distance(s, streams, 1, rows, uh, ul, fr, nullptr, 0,
                                    cfr, cfi, twr, twi, xdr, xdi);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(blend_tail_xfade<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_SMEM);
    if (err != cudaSuccess) return err;
    blend_tail_xfade<true><<<(rows + B_R - 1) / B_R, B_THREADS, B_SMEM, s>>>(
        xdr, xdi, rows, table, table_rows, idx_old, w_old, idx_new, w_new, 1, rows, xf,
        icr, ici, out);
    return cudaGetLastError();
  });
}
