// Gather-form fused render step for Hopper (sm_90a): sliding forward DFT,
// distance cue, complex multiply with pre-blended filter rows, tail IDFT
// and crossfade.
//
// Replaces the TPU kernel _kernel (jefferson_tpu/pallas/fused_step.py:868)
// in both of its forms, as fused_step_stream_xfade (:971) calls it over one
// stream (row 5) and fused_step_xfade (:1064) over S sources (row 6): one
// entry, jt_fused_step_gather_xfade, with the source count as an argument.
// The filter rows arrive blended (the caller's gather of a deduplicated
// blend, or a plain blend):
//
//   XD[r]    = launch A (fused_forward.cuh)
//   G_old[r] = g_rows[r]
//   G_new[r] = g_rows[r+1] inside a source, g_last[r / nb] at its last row
//   y_side   = tail128(IDFT(XD * G_side)) per ear
//   out[r]   = y_old * (1 - n/127) + y_new * n/127   where xf[r] > 0, else y_new
//
// jt_fused_apply_xfade replaces the apply-only TPU kernel _kernel
// (jefferson_tpu/pallas/fused_apply.py:59) of fused_apply_xfade (:133, row
// 7): launch B alone, on XD planes the caller computed, with the segment
// length in place of nb (the TPU kernel's roll patched at segment ends).
//
// with_xfade = 0 (the no-crossfade form): g_rows carries the NEW rows, and
// only the new side is computed (half the operand rows and tail work).
// Its per-element K order is the crossfade form's, so on a crossfade-free
// chunk the two forms give the same bits (out = y_old*0 + y_new*1 = y_new),
// the JAX package's contract (tests/test_noxfade.py:84-111).
//
// What bounds it: like the one-hot step, the tail IDFT's fp32 FMAs on the
// CUDA cores (17 GFLOP per 16,384 crossfading rows); the blended rows are
// read once per side from device memory (8.2 KB a row).  Design: the
// one-hot step's launch B without the blend.  One CTA per 32 rows, the
// (side, ear) products form a 128-row (crossfade) or 64-row (no-crossfade)
// operand, K tiled in 32-bin chunks through shared memory, 8 x 8 register
// tiles summed by 128-bin blocks (the blocked tail, fused_forward.cuh), the
// crossfade as the epilogue.  Every entry also takes launch B's split form
// (fused_forward.cuh: a cluster of CTAs a tile, one per 128-bin block, each
// filter row staged once), which gives the same bits.
//
// Geometry (fused_forward.cuh): both forms run at every geometry where
// they exist (launch B everywhere, the split form where HAS_SPLIT), a CTA
// per 32 rows and TT = 128 output columns, T_TILES along the grid's y (or,
// in the split form's pipelined layout, walked inside a CTA); below fpb 128,
// where fpb divides 128, T_COLS = fpb columns, 16 rows a CTA and each
// thread's register tile narrowed to it (B_ROWS, TailTile).  At
// a history of partial blocks (fpb 100, 441 under pad 1024) the entry with
// launch A refuses and jt_fused_apply_xfade is the step.

#include "fused_forward.cuh"

namespace {

constexpr int G_R = B_ROWS;             // output rows per CTA (16 where the tile fits)

template <int SIDES>
struct GatherShape {
  static constexpr int M = SIDES * 2 * G_R;         // (side, ear, row) operand rows
  static constexpr int THREADS = 2 * M;             // (M / 8) x 16 threads
  static constexpr size_t SMEM = sizeof(float) * (2 * M * T_QS + 2 * T_KC * T_COLS);
  static_assert(M * T_COLS <= 2 * M * T_QS + 2 * T_KC * T_COLS,
                "epilogue tile must fit in the main-loop shared memory");
};

template <int SIDES>
__global__ void __launch_bounds__(GatherShape<SIDES>::THREADS)
gather_tail_xfade(const float* __restrict__ xdr, const float* __restrict__ xdi,
                  int rows, int nb, const float* __restrict__ g_rows,
                  const float* __restrict__ g_last, const float* __restrict__ xf,
                  const float* __restrict__ icr, const float* __restrict__ ici,
                  float* __restrict__ out) {
  constexpr int M = GatherShape<SIDES>::M;
  constexpr int THREADS = GatherShape<SIDES>::THREADS;
  extern __shared__ float smem[];
  float* qr = smem;                 // [M][T_QS], m = (side*2 + ear)*G_R + row
  float* qi = qr + M * T_QS;
  float* br = qi + M * T_QS;        // [T_KC][T_COLS]
  float* bi = br + T_KC * T_COLS;
  float* y = smem;                  // epilogue [M][T_COLS], after the main loop
  __shared__ const float* grow[SIDES][G_R];   // each (side, row)'s filter row

  const int r0 = blockIdx.x * G_R;
  const int t0 = tile_t0();
  const int tid = threadIdx.x;
  if (tid < SIDES * G_R) {
    // The last side is the new one: with the crossfade, old row r+1 of the
    // same source or the source's final new row; without it, row r itself.
    const int side = tid / G_R, row = tid % G_R, r = r0 + row;
    const float* g = g_rows;
    if (r < rows) {
      if (SIDES == 1 || side == 0)
        g = g_rows + (size_t)r * C4;
      else
        g = r % nb + 1 < nb ? g_rows + (size_t)(r + 1) * C4 : g_last + (size_t)(r / nb) * C4;
    }
    grow[side][row] = g;
  }
  __syncthreads();

  constexpr int RI = TailTile::RI, CJ = TailTile::CJ;
  const int tx = tid % TailTile::TX, ty = tid / TailTile::TX;
  float acc[RI][CJ], part[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < BINS; k0 += T_KC) {
    if constexpr (T_FIT) start_fit_basis(br, bi, icr, ici, k0, tid, THREADS);
    for (int i = tid; i < G_R * T_KC; i += THREADS) {
      const int row = i / T_KC, kk = i % T_KC, k = k0 + kk, r = r0 + row;
      float q[SIDES][2][2] = {};    // [side][ear][re, im]
      if (k < BINS && r < rows) {
        const float xr = xdr[(size_t)r * BINS + k], xi = xdi[(size_t)r * BINS + k];
#pragma unroll
        for (int side = 0; side < SIDES; ++side) {
          const float* g = grow[side][row] + k;
#pragma unroll
          for (int ear = 0; ear < 2; ++ear)
            cmul_rn(xr, xi, g[2 * ear * BINS], g[(2 * ear + 1) * BINS],
                    &q[side][ear][0], &q[side][ear][1]);
        }
      }
#pragma unroll
      for (int side = 0; side < SIDES; ++side)
#pragma unroll
        for (int ear = 0; ear < 2; ++ear) {
          const int m = (side * 2 + ear) * G_R + row;
          qr[m * T_QS + kk] = q[side][ear][0];
          qi[m * T_QS + kk] = q[side][ear][1];
        }
    }
    if constexpr (T_FIT)
      cp_async_wait<0>();
    else
      load_tail_basis(br, bi, icr, ici, k0, t0, tid, THREADS);
    __syncthreads();
    tail_chunk_fma(part, qr, qi, br, bi, tx, ty);
    if (ends_tail_block(k0)) fold_tail_block(acc, part);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) y[(ty * RI + i) * T_COLS + TailTile::col(tx, j)] = acc[i][j];
  __syncthreads();

  // epilogue: out[r] = [L fpb | R fpb], this tile's columns
  for (int i = tid; i < G_R * 2 * T_W; i += THREADS) {
    const int row = i / (2 * T_W), col = i % (2 * T_W), r = r0 + row;
    if (r >= rows) break;
    const int ear = col / T_W, tt = col % T_W, t = t0 + tt;
    if (T_MASK && t >= FPB) continue;
    const float y_new = y[((SIDES - 1) * 2 + ear) * G_R * T_COLS + row * T_COLS + tt];
    float v = y_new;
    if (SIDES == 2) {
      const float y_old = y[(ear * G_R + row) * T_COLS + tt];
      const float fn = (float)t / (float)(FPB - 1);
      const bool on = xf[r] > 0.f;
      const float a = on ? __fsub_rn(1.f, fn) : 0.f;
      const float b = on ? fn : 1.f;
      v = __fadd_rn(__fmul_rn(y_old, a), __fmul_rn(y_new, b));
    }
    out[(size_t)r * 2 * FPB + ear * FPB + t] = v;
  }
}

template <int SIDES>
cudaError_t launch_gather_tail(cudaStream_t s, int form, const float* xdr, const float* xdi,
                               int rows, int nb, const float* g_rows, const float* g_last,
                               const float* xf, const float* icr, const float* ici,
                               float* out) {
  if (form == FORM_SPLIT)
    return launch_split_tail<SIDES>(s, xdr, xdi, rows, nb, RowsPreBlended{g_rows, g_last}, xf,
                                    icr, ici, out);
  if (form != FORM_LAUNCH_B) return cudaErrorInvalidValue;
  using Shape = GatherShape<SIDES>;
  cudaError_t err = cudaFuncSetAttribute(
      gather_tail_xfade<SIDES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Shape::SMEM);
  if (err != cudaSuccess) return err;
  gather_tail_xfade<SIDES><<<dim3((rows + G_R - 1) / G_R, T_TILES), Shape::THREADS, Shape::SMEM,
                             s>>>(
      xdr, xdi, rows, nb, g_rows, g_last, xf, icr, ici, out);
  return cudaGetLastError();
}

}  // namespace

// One gather-form step over num_sources streams of nb blocks each.  Launch
// A writes the XD planes to the caller's scratch (xdr, xdi: rows x 513,
// rows = num_sources * nb; pr, pi: its planes form's sub-block DFTs, as in
// jt_fused_step_onehot_xfade); launch B writes out (rows x 256).  g_rows is
// (rows x 2052); with_xfade != 0 also reads g_last (num_sources x 2052)
// and xf (rows), else both may be null.  dsel as in the one-hot step.
// form: launch B as FORM_LAUNCH_B (one CTA per 32 rows) or FORM_SPLIT (a
// cluster of CTAs per tile, fused_forward.cuh), the same bits; any
// other, or a form the geometry lacks, is refused (cudaErrorInvalidValue),
// and so is a history of partial blocks (launch A needs whole blocks).
// Launches on ``stream`` of ``device`` without synchronising, leaves the
// caller's current device as it was, and returns the first CUDA error.
extern "C" int jt_fused_step_gather_xfade(
    int device, void* stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* g_rows, const float* g_last, const float* xf, int with_xfade, int form,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    const float* icr, const float* ici,
    float* xdr, float* xdi, float* pr, float* pi, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (form != FORM_LAUNCH_B && form != FORM_SPLIT) return cudaErrorInvalidValue;
    cudaError_t err = launch_forward_distance(s, streams, num_sources, nb, uh, ul, fr,
                                              dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi, pr,
                                              pi);
    if (err != cudaSuccess) return err;
    const int rows = num_sources * nb;
    return with_xfade ? launch_gather_tail<2>(s, form, xdr, xdi, rows, nb, g_rows, g_last, xf,
                                              icr, ici, out)
                      : launch_gather_tail<1>(s, form, xdr, xdi, rows, nb, g_rows, g_last, xf,
                                              icr, ici, out);
  });
}

// The apply-only step (row 7): launch B on the caller's XD planes (xdr,
// xdi: rows x 513), with segments of seg rows (the new row of r is
// g_rows[r+1] inside a segment, g_last[r / seg] at its end; g_last is
// rows/seg x 2052).  with_xfade = 0: g_rows carries the NEW rows and
// g_last, xf may be null.  Launches on ``stream`` of ``device`` without
// synchronising and returns the first CUDA error.
extern "C" int jt_fused_apply_xfade(
    int device, void* stream, const float* xdr, const float* xdi, int rows, int seg,
    const float* g_rows, const float* g_last, const float* xf, int with_xfade, int form,
    const float* icr, const float* ici, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return with_xfade ? launch_gather_tail<2>(s, form, xdr, xdi, rows, seg, g_rows, g_last, xf,
                                              icr, ici, out)
                      : launch_gather_tail<1>(s, form, xdr, xdi, rows, seg, g_rows, g_last, xf,
                                              icr, ici, out);
  });
}
