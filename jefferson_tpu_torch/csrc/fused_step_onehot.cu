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
//   A (launch_forward_distance, fused_forward.cuh: the product form, or the
//     few-block form at nb <= FEW_NB blocks a source): XD to a scratch buffer.
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
//
// Rows 2-4 and 8 also take launch B's split form (fused_forward.cuh: a
// cluster of four CTAs per tile, one per 128-bin block, each table row
// blended once a tile), with the same bits; row 1 cannot (one chain).
//
// Row 8 at few rows (the live block step: one row) has its own launch, the
// cluster form (spatializer_cluster, below): launch B there builds a
// 128-row operand of which 4 rows are real and walks all of K on one SM.

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

// ---- row 8 at few rows: one cluster of five CTAs per output row ----------
//
// The blocked tail is five independent chains per output, one per 128-bin
// block, folded in order at the end; launch B walks them one after another
// on one SM.  Here CTA b of a row's cluster (b = 0..4) takes bins
// 128b .. 128b+127 (block 4: bin 512 alone):
//   - it stages its 128 rows of the tail basis (icr, ici: 64 KB a plane) in
//     shared memory with cp.async, four groups of 32 bins all in flight at
//     once, behind the blend;
//   - it blends its bins' q for every (side, ear) into shared memory in
//     launch B's exact op order (the same q bits);
//   - each thread owns one (side, t) and both ears: two fp32 chains that
//     start at 0 and run acc = fmaf(qr, br, acc); acc = fmaf(qi, bi, acc)
//     over the block's bins in ascending k, tail_chunk_fma's order;
//   - ranks 1-4 store their block partials into rank 0's shared memory
//     (distributed shared memory); after cluster.sync() rank 0 forms
//     ((((0 + p0) + p1) + p2) + p3) + p4, fold_tail_block's order, and runs
//     launch B's crossfade epilogue.
// So the result is launch B's bit for bit (side 0 old, side 1 new).
// What bounds it: each CTA's 128-step chain (about 1,000 cycles) and the
// launch; the basis (128 KB a CTA) comes from L2.
constexpr int C_BLOCKS = 5;                     // 128-bin tail blocks per row
constexpr int C_GROUP = 32;                     // bins per cp.async group
constexpr int C_GROUPS = T_BLOCK / C_GROUP;     // 4
constexpr int C_THREADS = 2 * FPB;              // one (side, t) per thread, both ears
constexpr int C_BASIS = 2 * T_BLOCK * FPB;      // [plane][bin][t]
constexpr int C_Q = 2 * 2 * 2 * T_BLOCK;        // [side][ear][re, im][bin]
constexpr int C_FOLD = (C_BLOCKS - 1) * 2 * 2 * FPB;  // [rank-1][side][ear][t]
constexpr size_t C_SMEM = sizeof(float) * (C_BASIS + C_Q + C_FOLD);
static_assert(T_BLOCK == FPB, "one blend thread per (side, bin) of a block");

__global__ void __cluster_dims__(C_BLOCKS, 1, 1) __launch_bounds__(C_THREADS)
spatializer_cluster(const float* __restrict__ xdr, const float* __restrict__ xdi,
                    const float* __restrict__ table, int table_rows,
                    const int* __restrict__ idx_old, const float* __restrict__ w_old,
                    const int* __restrict__ idx_new, const float* __restrict__ w_new,
                    const float* __restrict__ xf, const float* __restrict__ icr,
                    const float* __restrict__ ici, float* __restrict__ out) {
  extern __shared__ float smem[];          // 16-byte aligned: cp.async targets
  float* sbr = smem;                       // [T_BLOCK][FPB]
  float* sbi = sbr + T_BLOCK * FPB;
  float* sq = sbi + T_BLOCK * FPB;         // [side][ear][re, im][T_BLOCK]
  float* sfold = sq + C_Q;                 // rank 0's: the other ranks' partials
  __shared__ int sid[2][4];
  __shared__ float swt[2][4];

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x % C_BLOCKS;     // this CTA's rank and tail block
  const int r = blockIdx.x / C_BLOCKS;
  const int tid = threadIdx.x;
  const int k0 = b * T_BLOCK;
  const int nk = min(T_BLOCK, BINS - k0);  // 128, or 1 for block 4

  // Tell the cluster this CTA runs (its shared memory exists); the matching
  // wait comes before the partials are stored into rank 0.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  for (int g = 0; g < C_GROUPS; ++g) {     // rows [32g, 32g+32) of the block
    const int n4 = max(min(C_GROUP, nk - g * C_GROUP), 0) * (FPB / 4);
    for (int i = tid; i < 2 * n4; i += C_THREADS) {
      const int plane = i / n4, j = i % n4, row = g * C_GROUP + j / (FPB / 4);
      const int col = 4 * (j % (FPB / 4));
      cp_async16((plane ? sbi : sbr) + row * FPB + col,
                 (plane ? ici : icr) + (size_t)(k0 + row) * FPB + col);
    }
    cp_async_commit();
  }

  if (tid < 8) {
    // an id outside the table adds nothing: weight 0 on row 0 (launch B's rule)
    const int side = tid / 4, j = tid % 4;
    const int id = (side ? idx_new : idx_old)[r * 4 + j];
    const float wt = (side ? w_new : w_old)[r * 4 + j];
    const bool in_table = id >= 0 && id < table_rows;
    sid[side][j] = in_table ? id : 0;
    swt[side][j] = in_table ? wt : 0.f;
  }
  __syncthreads();

  const int side = tid / FPB;
  {
    // q of (side, bin kk) for both ears, launch B's op order
    const int kk = tid % T_BLOCK;
    float q[2][2] = {};                    // [ear][re, im]
    if (kk < nk) {
      const int k = k0 + kk;
      const float xr = xdr[(size_t)r * BINS + k], xi = xdi[(size_t)r * BINS + k];
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* trow = table + (size_t)sid[side][j] * C4 + k;
        const float wj = swt[side][j];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float v = __fmul_rn(wj, trow[p * BINS]);
          g[p] = j == 0 ? v : __fadd_rn(g[p], v);
        }
      }
#pragma unroll
      for (int ear = 0; ear < 2; ++ear)
        cmul_rn(xr, xi, g[2 * ear], g[2 * ear + 1], &q[ear][0], &q[ear][1]);
    }
#pragma unroll
    for (int ear = 0; ear < 2; ++ear)
#pragma unroll
      for (int c = 0; c < 2; ++c) sq[((side * 2 + ear) * 2 + c) * T_BLOCK + kk] = q[ear][c];
  }

  const int t = tid % FPB;
  const float* q0 = sq + (side * 2 + 0) * 2 * T_BLOCK;   // ear 0: [re, im][bin]
  const float* q1 = sq + (side * 2 + 1) * 2 * T_BLOCK;
  float acc[2] = {0.f, 0.f};
  for (int g = 0; g < C_GROUPS; ++g) {
    cp_async_wait_n(C_GROUPS - 1 - g); // this thread's rows of group g landed
    __syncthreads();                       // everyone's, and q
    const int hi = min((g + 1) * C_GROUP, nk);
#pragma unroll 8
    for (int kk = g * C_GROUP; kk < hi; ++kk) {
      const float br = sbr[kk * FPB + t], bi = sbi[kk * FPB + t];
      acc[0] = fmaf(q0[kk], br, acc[0]);
      acc[0] = fmaf(q0[T_BLOCK + kk], bi, acc[0]);
      acc[1] = fmaf(q1[kk], br, acc[1]);
      acc[1] = fmaf(q1[T_BLOCK + kk], bi, acc[1]);
    }
  }

  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every rank runs
  if (b > 0) {
    float* dst = cluster.map_shared_rank(sfold, 0);
#pragma unroll
    for (int ear = 0; ear < 2; ++ear) dst[(((b - 1) * 2 + side) * 2 + ear) * FPB + t] = acc[ear];
  }
  cluster.sync();                          // the partials are in rank 0
  if (b > 0) return;

  // crossfade epilogue, launch B's: out[r] = [L 128 | R 128]; sq is free now
  float* ys = sq;                          // [side][ear][t]
#pragma unroll
  for (int ear = 0; ear < 2; ++ear) {
    float y = __fadd_rn(0.f, acc[ear]);
#pragma unroll
    for (int rank = 1; rank < C_BLOCKS; ++rank)
      y = __fadd_rn(y, sfold[(((rank - 1) * 2 + side) * 2 + ear) * FPB + t]);
    ys[(side * 2 + ear) * FPB + t] = y;
  }
  __syncthreads();
  const int col = tid, ear = col / FPB, tt = col % FPB;
  const float y_old = ys[ear * FPB + tt], y_new = ys[(2 + ear) * FPB + tt];
  const float fn = (float)tt / (float)(FPB - 1);
  const bool on = xf[r] > 0.f;
  const float a = on ? __fsub_rn(1.f, fn) : 0.f;
  const float bn = on ? fn : 1.f;
  out[(size_t)r * 2 * FPB + col] = __fadd_rn(__fmul_rn(y_old, a), __fmul_rn(y_new, bn));
}

}  // namespace

// One fused step.  Launch A runs the forward over num_sources streams of
// nb blocks each and writes the XD planes to the caller's scratch (xdr,
// xdi: rows x 513 each, rows = num_sources * nb); launch B writes out
// (rows x 256).  Every pointer is device memory; dsel is null for per-row
// distance (uh/ul/fr then have one entry per row), else it selects each
// row's triple among the first n_dist.  table holds u_rows rows per group
// of group_rows output rows; bnd_idx/bnd_w hold one row per seg output
// rows; blocked_tail != 0 sums the tail by 128-bin blocks.  form: the
// blocked tail's launch B as FORM_LAUNCH_B (one CTA per 32 rows) or
// FORM_SPLIT (a cluster of four CTAs per tile, fused_forward.cuh: the same
// bits; it needs group_rows % seg == 0); one chain over K only as
// FORM_LAUNCH_B; anything else is refused (cudaErrorInvalidValue).
// Launches on ``stream`` of ``device`` without synchronising, leaves the
// caller's current device as it was, and returns the first CUDA error (0
// when both launches went).
extern "C" int jt_fused_step_onehot_xfade(
    int device, void* stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* table, int u_rows, const int* ridx, const float* w,
    const int* bnd_idx, const float* bnd_w, int seg, int group_rows, int blocked_tail,
    int form, const float* xf,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    const float* icr, const float* ici,
    float* xdr, float* xdi, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!(form == FORM_LAUNCH_B || (form == FORM_SPLIT && blocked_tail && group_rows % seg == 0)))
      return cudaErrorInvalidValue;
    cudaError_t err = launch_forward_distance(s, streams, num_sources, nb, uh, ul, fr,
                                              dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
    if (err != cudaSuccess) return err;
    const int rows = num_sources * nb;
    if (form == FORM_SPLIT)
      return launch_split_tail<2>(
          s, xdr, xdi, rows, seg,
          RowsBlended{table, u_rows, ridx, w, bnd_idx, bnd_w, group_rows}, xf, icr, ici, out);
    auto kernel = blocked_tail ? blend_tail_xfade<true> : blend_tail_xfade<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)B_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<(rows + B_R - 1) / B_R, B_THREADS, B_SMEM, s>>>(
        xdr, xdi, rows, table, u_rows, ridx, w, bnd_idx, bnd_w, seg, group_rows, xf,
        icr, ici, out);
    return cudaGetLastError();
  });
}

// Launch A alone in ``form`` (FWD_TILE, FWD_PRODUCT or FWD_FEW of
// fused_forward.cuh; anything else is refused): the XD
// planes (xdr, xdi: rows x 513, rows = num_sources * nb) of num_sources
// streams of nb blocks, with per-row distance or, with dsel, each row's
// triple among the first n_dist.  The card tests and chip_smoke.py hold
// the forms against each other through it.  Launches on ``stream`` of
// ``device`` without synchronising and returns the first CUDA error.
extern "C" int jt_forward_distance(
    int device, void* stream, int form, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi) {
  return on_device(device, [&]() {
    return launch_forward_form(form, static_cast<cudaStream_t>(stream), streams, num_sources,
                               nb, uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
  });
}

// Row 8, the full-table blend-apply-tail step (jefferson_tpu/pallas/
// fused_spatializer.py _kernel :46 of fused_apply :102): every row's old
// side blends idx_old[r] and its new side idx_new[r], both against the whole
// table (table_rows rows), the blocked tail, and the crossfade where
// xf[r] > 0.  ``form`` picks launch B's form: 0 launch B with seg = 1 (one
// group), 1 the cluster form (spatializer_cluster), 2 the split form
// (fused_forward.cuh) with seg = 1; anything else is refused.  With
// streams null, xdr and xdi are the caller's XD planes (rows x 513); else
// launch A first writes them from one stream of rows blocks (streams:
// (rows + 7) x 128 samples, history first) with per-row distance uh/ul/fr
// (rows each).  The live block step runs the cluster form at one row, the
// scan render another form at every row of a chunk.  Launches on
// ``stream`` of ``device`` without synchronising and returns the first
// CUDA error.
extern "C" int jt_fused_spatializer_apply(
    int device, void* stream, int rows, int form,
    const float* streams, const float* uh, const float* ul, const float* fr,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi,
    const float* table, int table_rows, const int* idx_old, const float* w_old,
    const int* idx_new, const float* w_new, const float* xf,
    const float* icr, const float* ici, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (form < 0 || form > 2) return cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (streams)
      err = launch_forward_distance(s, streams, 1, rows, uh, ul, fr, nullptr, 0,
                                    cfr, cfi, twr, twi, xdr, xdi);
    if (err != cudaSuccess) return err;
    if (form == 1) {
      err = cudaFuncSetAttribute(spatializer_cluster,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C_SMEM);
      if (err != cudaSuccess) return err;
      spatializer_cluster<<<C_BLOCKS * rows, C_THREADS, C_SMEM, s>>>(
          xdr, xdi, table, table_rows, idx_old, w_old, idx_new, w_new, xf, icr, ici, out);
      return cudaGetLastError();
    }
    if (form == 2)
      return launch_split_tail<2>(
          s, xdr, xdi, rows, 1,
          RowsBlended{table, table_rows, idx_old, w_old, idx_new, w_new, rows}, xf, icr, ici,
          out);
    err = cudaFuncSetAttribute(blend_tail_xfade<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B_SMEM);
    if (err != cudaSuccess) return err;
    blend_tail_xfade<true><<<(rows + B_R - 1) / B_R, B_THREADS, B_SMEM, s>>>(
        xdr, xdi, rows, table, table_rows, idx_old, w_old, idx_new, w_new, 1, rows, xf,
        icr, ici, out);
    return cudaGetLastError();
  });
}

