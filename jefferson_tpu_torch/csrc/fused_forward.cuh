// Pieces shared by the port's fused render steps (fused_step_onehot.cu and
// fused_step_gather.cu): launch A, the in-kernel forward DFT and distance
// cue, and the tail-IDFT inner loop of launch B.
//
// Launch A (launch_forward_distance) replaces the TPU kernels' shared forward,
// jefferson_tpu/pallas/fused_step.py _forward_planes (:273) with
// _select_distance (:163) and _distance_planes (:259).  Per output row
// r = s*nb + b (source s, block b) it computes
//
//   X[r]  = sum_{m<8} tw[m] * P[s, b+m],  P = 128-sample sub-block DFTs
//   XD[r] = X[r] * D(u_hi, u_lo, inv_frac)
//
// XD goes to a scratch buffer (rows x 513 x 2 floats) that launch B reads.
// Launch A has five forms with the same bits (launch_forward_form): the
// tile form (forward_distance: one CTA per (32 blocks, 64 bins, source),
// the sub-block samples and a (128 x 64) slice of the DFT basis in shared
// memory, the twiddle sum and the distance multiply on the CTA's P tile),
// kept to hold the others against where it exists; the product form, which
// the render steps take; the few-block form, which they take at nb <=
// FEW_NB blocks a source (the live step); the ring form, which they take
// past Q 16 where the product form does not exist and it pays (ring_pays;
// one launch, each CTA a run of one source's blocks with its P in a
// shared-memory ring); and the planes form, which takes any Q in two
// launches (P written to a scratch of the caller's, then the twiddle sum
// read through L2), taken where the ring form does not pay and kept to
// hold it against.  Every launch B form reads the same XD.
//
// Geometry: each library is built for one (fpb, pad_len), passed as
// -DJT_FPB=<fpb> -DJT_PAD=<pad> (kernels/build.py); BINS = PAD/2 + 1 and,
// when the history is whole blocks (PAD % FPB == 0), Q = PAD/FPB.  Any fpb
// >= 2 and any power-of-two pad build: the planes form takes launch A and
// launch B every geometry.  The other forms exist where their HAS_* flag
// says (their tiles and register arrays are laid out for some geometries
// only); at fpb 128 / pad 1024 each compiles to the form it was measured
// as.  A history of partial blocks has no launch A (the caller computes
// XD); its entries take launch B alone (rows 7 and 8's apply-only forms).
//
// Numerics: every product whose rounding the JAX op order fixes (twiddle
// sum, distance planes with the 12-bit phase split, complex multiplies) is
// written with __fmul_rn/__fadd_rn/__fsub_rn so FMA contraction cannot
// move it; only the DFT dot products accumulate with fmaf, in fp32, in
// another order than XLA's (~1e-7 relative).  cosf/sinf are the precise
// library functions: build without fast math.

#pragma once

#include <atomic>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "entry.cuh"

namespace {

#ifndef JT_FPB
#define JT_FPB 128
#endif
#ifndef JT_PAD
#define JT_PAD 1024
#endif
// the forms tuned for fpb 128 / pad 1024 alone: row 1's staged launch B and
// row 8's cluster form
#define JT_TUNED_128 (JT_FPB == 128 && JT_PAD == 1024)
static_assert(JT_FPB >= 2 && JT_PAD >= JT_FPB && (JT_PAD & (JT_PAD - 1)) == 0,
              "a geometry: fpb >= 2, pad a power of two >= fpb");

constexpr int FPB = JT_FPB;     // samples per block = sub-block length
constexpr int PAD = JT_PAD;     // transform length
constexpr int BINS = PAD / 2 + 1;   // half-spectrum of the PAD-point DFT
constexpr bool ALIGNED = PAD % FPB == 0;   // the history is whole blocks: launch A runs
constexpr int Q = ALIGNED ? PAD / FPB : 1; // sub-blocks per window
constexpr int C4 = 4 * BINS;    // combined filter row [rL | iL | rR | iR]

// ---- launch A: sub-block DFT, twiddle sum, distance multiply -------------
constexpr int A_BT = 32;                // output blocks per CTA
constexpr int A_KT = 64;                // bins per CTA
constexpr int A_THREADS = 256;          // 64 columns x 4 row groups
constexpr int A_RG = A_THREADS / A_KT;  // 4 row groups
constexpr int A_ROWS = (A_BT + Q - 1 + A_RG - 1) / A_RG * A_RG;  // 39 sub-blocks -> 40 at Q 8
// A sub-block's DFT is one fmaf chain ascending from sample 0 up to fpb
// 128; a longer sub-block sums its 128-sample chains in order, each from 0
// ((0 + c0) + c1) + ..., as the blocked tail sums its 128-bin blocks, so
// the chain's rounding does not grow with fpb.  Every form does the same.
constexpr int F_BLOCK = 128;            // samples a DFT chain
constexpr bool DFT_BLOCKED = FPB > F_BLOCK;
constexpr int A_NC = FPB < F_BLOCK ? FPB : F_BLOCK;   // samples staged at once
constexpr int A_ROWS_PER_THREAD = A_ROWS / A_RG;                 // 10 at Q 8
constexpr int A_OUT_PER_THREAD = A_BT / A_RG;                    // 8
constexpr size_t A_SMEM =
    sizeof(float) * (A_ROWS * A_NC + 2 * A_NC * A_KT + 2 * A_ROWS * A_KT);
static_assert(!ALIGNED || FPB % A_NC == 0, "whole sample chunks");

// ---- launch B's tail IDFT: 32-bin K chunks, 8 x 8 register tiles ---------
constexpr int T_KC = 32;                // bins per K chunk
constexpr int T_QS = T_KC + 1;          // padded row stride of a q chunk
// A CTA's tail covers TT output columns t (one t-tile; FPB at fpb 128).
// Larger fpb take T_TILES tiles: along the grid's y in launch B and the
// split form's chunked layout (each CTA builds its rows' q again), inside
// the CTA in its pipelined layout (q built once).  A smaller fpb that
// divides TT (64, 32, ..., 2) fits the tile to the block: T_COLS = FPB
// columns, so no FMA, shared memory or basis copy is spent past FPB, and
// each thread's register tile narrows (TailTile, SplitTile).  One that does
// not (fpb 100) keeps the TT-column tile, its columns past FPB unused
// (their basis is 0 and nothing stores them).
constexpr int TT = 128;
constexpr int T_TILES = (FPB + TT - 1) / TT;
constexpr bool T_FIT = FPB < TT && TT % FPB == 0;  // the tile is as wide as the block
constexpr int T_COLS = T_FIT ? FPB : TT;           // columns a tile spans
constexpr int T_W = FPB < TT ? FPB : TT;           // columns a full tile stores
constexpr bool B_MASK = FPB % T_COLS != 0;         // some basis columns lie past FPB
constexpr bool T_MASK = FPB > TT && FPB % TT != 0; // the last tile is ragged

// Where the tuned layouts fit (kernels/fused_step.geometry_forms mirrors
// these): launch A's tile form (its twiddle sum keeps Q twiddles in
// registers and its tile 32 + Q - 1 sub-block rows in shared memory: Q <=
// 16), its product form (64-bin slices plus the last bin, 32-sample K
// chunks, tiles whose output starts stay most of their rows: Q <= 64), its
// few-block form (static shared memory under 48 KB); launch B's split form
// (whole 128-bin tail blocks, at most 16: HAS_SPLIT, with the layouts below).
constexpr int TILE_MAX_Q = 16;
constexpr int PRODUCT_MAX_Q = 64;
constexpr bool HAS_TILE = ALIGNED && Q <= TILE_MAX_Q;
constexpr bool HAS_PRODUCT = ALIGNED && BINS - 1 >= 64 && (BINS - 1) % 64 == 0 && FPB % 32 == 0 &&
                             Q <= PRODUCT_MAX_Q;
constexpr int T_BLOCK = 128;            // bins a block of the blocked tail

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

template <int QT>  // = Q: instantiated only where HAS_TILE
__global__ void __launch_bounds__(A_THREADS)
forward_distance(const float* __restrict__ streams, int nb,
                 const float* __restrict__ uh, const float* __restrict__ ul,
                 const float* __restrict__ fr, const int* __restrict__ dsel, int n_dist,
                 const float* __restrict__ cfr, const float* __restrict__ cfi,
                 const float* __restrict__ twr, const float* __restrict__ twi,
                 float* __restrict__ xdr, float* __restrict__ xdi) {
  extern __shared__ float smem[];
  float* subs = smem;                       // [A_ROWS][A_NC]
  float* bre = subs + A_ROWS * A_NC;        // [A_NC][A_KT]
  float* bim = bre + A_NC * A_KT;
  float* pre = bim + A_NC * A_KT;           // [A_ROWS][A_KT]
  float* pim = pre + A_ROWS * A_KT;

  const int b0 = blockIdx.x * A_BT;
  const int k0 = blockIdx.y * A_KT;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int nbt = min(A_BT, nb - b0);       // output blocks of this tile
  const int nsub = nbt + Q - 1;             // sub-blocks it reads

  // sub-blocks [b0, b0 + nsub) of source s are contiguous samples
  const float* src = streams + (size_t)s * (nb + Q - 1) * FPB + (size_t)b0 * FPB;
  // P = subs @ basis slice: thread owns column c, rows rg*10 .. rg*10+9; the
  // samples arrive A_NC at a time, each chain still ascending from sample 0
  const int c = tid % A_KT;
  const int rg = tid / A_KT;
  float acc_r[A_ROWS_PER_THREAD], acc_i[A_ROWS_PER_THREAD];
  float tot_r[A_ROWS_PER_THREAD], tot_i[A_ROWS_PER_THREAD];   // DFT_BLOCKED: the chains' sum
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) acc_r[i] = acc_i[i] = tot_r[i] = tot_i[i] = 0.f;
  for (int n0 = 0; n0 < FPB; n0 += A_NC) {
    for (int i = tid; i < A_ROWS * A_NC; i += A_THREADS) {
      const int r = i / A_NC, n = i % A_NC;
      subs[i] = r < nsub ? src[r * FPB + n0 + n] : 0.f;
    }
    for (int i = tid; i < A_NC * A_KT; i += A_THREADS) {
      const int n = n0 + i / A_KT, k = k0 + i % A_KT;
      bre[i] = k < BINS ? cfr[n * BINS + k] : 0.f;
      bim[i] = k < BINS ? cfi[n * BINS + k] : 0.f;
    }
    __syncthreads();
    for (int n = 0; n < A_NC; ++n) {
      const float br = bre[n * A_KT + c], bi = bim[n * A_KT + c];
#pragma unroll
      for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
        const float x = subs[(rg * A_ROWS_PER_THREAD + i) * A_NC + n];
        acc_r[i] = fmaf(x, br, acc_r[i]);
        acc_i[i] = fmaf(x, bi, acc_i[i]);
      }
    }
    if constexpr (DFT_BLOCKED) {             // a chunk is one 128-sample chain
#pragma unroll
      for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
        tot_r[i] = __fadd_rn(tot_r[i], acc_r[i]);
        tot_i[i] = __fadd_rn(tot_i[i], acc_i[i]);
        acc_r[i] = acc_i[i] = 0.f;
      }
    }
    if (n0 + A_NC < FPB) __syncthreads();   // the next chunk overwrites this one
  }
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    pre[(rg * A_ROWS_PER_THREAD + i) * A_KT + c] = DFT_BLOCKED ? tot_r[i] : acc_r[i];
    pim[(rg * A_ROWS_PER_THREAD + i) * A_KT + c] = DFT_BLOCKED ? tot_i[i] : acc_i[i];
  }
  __syncthreads();

  const int k = k0 + c;
  if (k >= BINS) return;
  float tr[QT], ti[QT];
#pragma unroll
  for (int m = 1; m < QT; ++m) {
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
    for (int m = 1; m < QT; ++m) {
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

std::atomic<unsigned long long> tile_smem_set{0};

// ---- launch A's product form and few-block form ---------------------------
//
// The forward is a product P = subs @ basis ((S*(nb+7)) x 128 by 128 x 513,
// re and im) followed per output by a twiddle sum over 8 rows of P and the
// distance multiply.  Sub-block j of source s is flat row g = s*(nb+7) + j
// of the contiguous streams array (samples g*128 ..), so the product runs
// over every source's rows at once; output row s*nb + j reads P rows g ..
// g+7.  Both forms keep the tile form's bits: each P[g, k] is one fmaf
// chain over the 128 samples in ascending order from 0, and the twiddle
// sum, distance plane and complex multiply are the same code on the same
// values.
//
// Product form (forward_distance_product).  What held the tile form back
// (PERF.md, launch A): 12 shared-memory loads for 20 FFMAs in its DFT loop,
// each sub-block's DFT computed 1.25x over, a ninth bin tile holding bin
// 512 alone, and precise cosf/sinf for every row and bin.  Here a CTA
// multiplies G_ROWS = 64 consecutive flat rows by a 64-bin slice (8
// slices; the last also carries bin 512, so no CTA works on one bin), K in
// four 32-sample chunks, two chunks in flight by cp.async.  A thread holds
// a 4-row x 4-bin tile of both planes (rows rg + 16i, so a warp's float4
// row loads fall in distinct banks): per sample 3 shared-memory wavefronts
// a warp for 32 FFMAs, 80 registers, three CTAs an SM.  The tile's P then
// lies in shared memory, and each thread runs down one bin column over a
// quarter of the tile's outputs, reading one new P row an output.  The
// G_OUT = 57 output starts whose 8 rows lie in the tile are its own, so
// tiles step by 57 rows and each P row is computed 1.12x over.  128-row
// tiles (8 x 4 a thread, two CTAs an SM) took 3-6% less at 256 x 64 and up
// to 1.3x longer at the other shapes: they leave the last wave of a grid
// nearly empty (PERF.md, launch A).
// With a triple selector (n_dist <= D_UNIQ) the distance planes are
// computed once a CTA per (triple, bin), while the first chunks are in
// flight, and selected per row, as the JAX package's _select_distance does
// (the same function of triple and bin, so the same bits); without one,
// per row.
// At Q > 16 (fpb 32 under pad 1024 or more) a tile holds 128 rows, so that
// its output starts (G_OUT) stay most of its rows, at two CTAs an SM.
constexpr int D_UNIQ = 8;                     // fused_step.MAX_DIST_UNIQ
constexpr int G_ROWS = Q <= 16 ? 64 : 128;    // flat sub-block rows a tile
constexpr int G_MIN_CTAS = G_ROWS == 64 && !DFT_BLOCKED ? 3 : 2;   // blocked: 34 more registers
constexpr int G_RT = G_ROWS / 16;             // rows a thread
constexpr int G_OUT = G_ROWS - Q + 1;         // output starts a tile
constexpr int G_KT = 64;                      // bins a slice
constexpr int G_SLICES = HAS_PRODUCT ? (BINS - 1) / G_KT : 1;   // 8; the last also bin 512
constexpr int G_KC = 32;                      // samples a K chunk
constexpr int G_CHUNKS = FPB / G_KC;
constexpr int G_FOLD = F_BLOCK / G_KC;        // K chunks a 128-sample chain (DFT_BLOCKED)
constexpr int G_THREADS = 256;                // 16 row groups x 16 bin groups
constexpr int G_AS = G_KC + 4;                // padded row stride of an A chunk
constexpr int G_BS = 2 * G_KT;                // a B chunk row: 64 re | 64 im
constexpr int G_STAGE = G_ROWS * G_AS + G_KC * G_BS + 2 * G_KC;   // A, B, bin 512's B
constexpr int G_PS = G_KT + 4;                // P row stride: the slice, then bin 512
constexpr int G_PLANE = G_ROWS * G_PS;
constexpr int G_DS = G_KT + 1;                // distance table row: the slice, bin 512
constexpr int G_RUN = (G_OUT + 3) / 4;        // outputs a thread's run (4 runs a column)
constexpr int G_BUF = 2 * G_STAGE > 2 * G_PLANE ? 2 * G_STAGE : 2 * G_PLANE;
constexpr size_t G_SMEM = sizeof(float) * (G_BUF + 2 * D_UNIQ * G_DS);
static_assert(!HAS_PRODUCT || G_SLICES * G_KT == BINS - 1, "slices cover bins 0-511");
static_assert(!HAS_PRODUCT || (G_OUT >= 1 && G_OUT <= G_THREADS && G_ROWS <= G_THREADS),
              "a tile's outputs");
static_assert(G_STAGE % 4 == 0 && G_PLANE % 4 == 0 && G_BUF % 4 == 0, "float4 alignment");

std::atomic<unsigned long long> product_smem_set[2];   // by VEC

// The twiddle sum of an output from the 8 P values w[0..7] of its window.
__device__ __forceinline__ void twiddle_sum(const float (&wr)[Q], const float (&wi)[Q],
                                            const float (&tr)[Q], const float (&ti)[Q],
                                            float* xr_out, float* xi_out) {
  float xr = wr[0], xi = wi[0];
#pragma unroll
  for (int m = 1; m < Q; ++m) {
    xr = __fadd_rn(xr, __fsub_rn(__fmul_rn(tr[m], wr[m]), __fmul_rn(ti[m], wi[m])));
    xi = __fadd_rn(xi, __fadd_rn(__fmul_rn(tr[m], wi[m]), __fmul_rn(ti[m], wr[m])));
  }
  *xr_out = xr;
  *xi_out = xi;
}

// A row's triple: itself, or its selector where one is given (outside
// 1..n_dist-1: triple 0, as on the TPU).
__device__ __forceinline__ int triple_of(int row, const int* __restrict__ dsel, int n_dist) {
  if (!dsel) return row;
  const int t = dsel[row];
  return t > 0 && t < n_dist ? t : 0;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A tile's outputs from its P planes [row][G_PS]: the output starts g0 ..
// g0 + G_OUT - 1 that are blocks of a source.  Thread t runs down bin
// column t % 64 over a quarter of them, its window of 8 P rows sliding one
// row an output (four outputs in flight a thread measured no faster); in
// the last slice, bin 512 takes one output a thread.
template <int QT = Q>  // instantiated by the product form alone
__device__ __forceinline__ void tile_outputs(
    const float* pr, const float* pi, const float* dtab, bool table, bool nyq, int t, int g0,
    int total, int nb, int k0, const float* __restrict__ uh, const float* __restrict__ ul,
    const float* __restrict__ fr, const int* __restrict__ dsel, int n_dist,
    const float* __restrict__ twr, const float* __restrict__ twi,
    float* __restrict__ xdr, float* __restrict__ xdi) {
  const int L = nb + Q - 1;
  const int n_out = min(G_OUT, total - (Q - 1) - g0);
  const float* dti = dtab + D_UNIQ * G_DS;
  const int col = t & (G_KT - 1);
  const int o0 = (t / G_KT) * G_RUN, o1 = min(o0 + G_RUN, n_out);
  const int k = k0 + col;
  if (o0 < o1) {
    float tr[QT], ti[QT], wr[QT], wi[QT];
#pragma unroll
    for (int m = 1; m < Q; ++m) {
      tr[m] = twr[m * BINS + k];
      ti[m] = twi[m * BINS + k];
    }
#pragma unroll
    for (int m = 0; m < Q - 1; ++m) {
      wr[m] = pr[(o0 + m) * G_PS + col];
      wi[m] = pi[(o0 + m) * G_PS + col];
    }
    const int g = g0 + o0;
    int s = g / L, j = g - s * L;   // output o's source and block
    const float kf = (float)k;
    for (int o = o0; o < o1; ++o) {
      wr[Q - 1] = pr[(o + Q - 1) * G_PS + col];
      wi[Q - 1] = pi[(o + Q - 1) * G_PS + col];
      if (j < nb) {
        float xr, xi, dr, di;
        twiddle_sum(wr, wi, tr, ti, &xr, &xi);
        const int row = s * nb + j;
        const int d = triple_of(row, dsel, n_dist);
        if (table) {
          dr = dtab[d * G_DS + col];
          di = dti[d * G_DS + col];
        } else {
          distance_plane(uh[d], ul[d], fr[d], kf, &dr, &di);
        }
        cmul_rn(xr, xi, dr, di, &xdr[(size_t)row * BINS + k], &xdi[(size_t)row * BINS + k]);
      }
#pragma unroll
      for (int m = 0; m < Q - 1; ++m) {
        wr[m] = wr[m + 1];
        wi[m] = wi[m + 1];
      }
      if (++j == L) {
        j = 0;
        ++s;
      }
    }
  }
  if (nyq && t < n_out) {
    const int g = g0 + t, s = g / L, j = g - s * L;
    if (j < nb) {
      float tr[QT], ti[QT], wr[QT], wi[QT], xr, xi, dr, di;
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        tr[m] = twr[m * BINS + BINS - 1];
        ti[m] = twi[m * BINS + BINS - 1];
        wr[m] = pr[(t + m) * G_PS + G_KT];
        wi[m] = pi[(t + m) * G_PS + G_KT];
      }
      twiddle_sum(wr, wi, tr, ti, &xr, &xi);
      const int row = s * nb + j;
      const int d = triple_of(row, dsel, n_dist);
      if (table) {
        dr = dtab[d * G_DS + G_KT];
        di = dti[d * G_DS + G_KT];
      } else {
        distance_plane(uh[d], ul[d], fr[d], (float)(BINS - 1), &dr, &di);
      }
      cmul_rn(xr, xi, dr, di, &xdr[(size_t)row * BINS + BINS - 1],
              &xdi[(size_t)row * BINS + BINS - 1]);
    }
  }
}

template <bool VEC>  // VEC: streams 16-byte aligned, its rows copied 16 bytes at a time
__global__ void __launch_bounds__(G_THREADS, G_MIN_CTAS)
forward_distance_product(const float* __restrict__ streams, int num_sources, int nb,
                         const float* __restrict__ uh, const float* __restrict__ ul,
                         const float* __restrict__ fr, const int* __restrict__ dsel,
                         int n_dist,
                         const float* __restrict__ cfr, const float* __restrict__ cfi,
                         const float* __restrict__ twr, const float* __restrict__ twi,
                         float* __restrict__ xdr, float* __restrict__ xdi) {
  extern __shared__ __align__(16) float smem[];
  float* dtab = smem + G_BUF;                 // [plane][triple][G_DS]
  const int tid = threadIdx.x;
  const int total = num_sources * (nb + Q - 1);   // flat sub-block rows
  const int g0 = blockIdx.x * G_OUT;
  const int k0 = blockIdx.y * G_KT;
  const bool nyq = blockIdx.y == G_SLICES - 1;

  auto load_chunk = [&](int c) {
    float* as = smem + (c & 1) * G_STAGE;
    float* bs = as + G_ROWS * G_AS;
    float* bn = bs + G_KC * G_BS;
    const int n0 = c * G_KC;
    if (VEC) {
      for (int i = tid; i < G_ROWS * G_KC / 4; i += G_THREADS) {
        const int r = i / (G_KC / 4), q4 = 4 * (i % (G_KC / 4));
        float* dst = as + r * G_AS + q4;
        if (g0 + r < total)
          cp_async16(dst, streams + (size_t)(g0 + r) * FPB + n0 + q4);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < G_ROWS * G_KC; i += G_THREADS) {
        const int r = i / G_KC, n = i % G_KC;
        if (g0 + r < total)
          cp_async4(as + r * G_AS + n, streams + (size_t)(g0 + r) * FPB + n0 + n);
        else
          as[r * G_AS + n] = 0.f;
      }
    }
    for (int i = tid; i < G_KC * G_KT; i += G_THREADS) {
      const int n = i / G_KT, kk = i % G_KT;
      const size_t src = (size_t)(n0 + n) * BINS + k0 + kk;
      cp_async4(bs + n * G_BS + kk, cfr + src);
      cp_async4(bs + n * G_BS + G_KT + kk, cfi + src);
    }
    if (nyq && tid < 2 * G_KC)  // bn[2n + plane]: bin 512 of sample n0 + n
      cp_async4(bn + tid, ((tid & 1) ? cfi : cfr) + (size_t)(n0 + (tid >> 1)) * BINS + BINS - 1);
    cp_async_commit();
  };

  load_chunk(0);
  if (G_CHUNKS > 1) load_chunk(1);
  const bool table = dsel != nullptr && n_dist <= D_UNIQ;
  if (table) {
    for (int i = tid; i < n_dist * G_DS; i += G_THREADS) {
      const int t = i / G_DS, c = i % G_DS;
      if (c < G_KT || nyq)
        distance_plane(uh[t], ul[t], fr[t], (float)(c < G_KT ? k0 + c : BINS - 1),
                       &dtab[t * G_DS + c], &dtab[(D_UNIQ + t) * G_DS + c]);
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int rg = (warp >> 1) * 4 + (lane >> 3);   // rows rg + 16i
  const int bg = (warp & 1) * 8 + (lane & 7);     // bins 4bg .. 4bg+3 of the slice
  const bool nyq_row = nyq && tid < G_ROWS;       // bin 512 of row tid
  float accr[G_RT][4], acci[G_RT][4];
  float totr[DFT_BLOCKED ? G_RT : 1][4], toti[DFT_BLOCKED ? G_RT : 1][4];   // the chains' sum
#pragma unroll
  for (int i = 0; i < G_RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[i][j] = acci[i][j] = 0.f;
  if constexpr (DFT_BLOCKED) {
#pragma unroll
    for (int i = 0; i < G_RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) totr[i][j] = toti[i][j] = 0.f;
  }
  float nr = 0.f, ni = 0.f, ntr = 0.f, nti = 0.f;

  for (int c = 0; c < G_CHUNKS; ++c) {
    if (c + 1 < G_CHUNKS) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const float* as = smem + (c & 1) * G_STAGE;
    const float* bs = as + G_ROWS * G_AS;
    const float* bn = bs + G_KC * G_BS;
#pragma unroll 2
    for (int k4 = 0; k4 < G_KC / 4; ++k4) {
      float4 a[G_RT];
#pragma unroll
      for (int i = 0; i < G_RT; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (rg + 16 * i) * G_AS + 4 * k4);
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const float4 br = *reinterpret_cast<const float4*>(bs + (4 * k4 + kq) * G_BS + 4 * bg);
        const float4 bi =
            *reinterpret_cast<const float4*>(bs + (4 * k4 + kq) * G_BS + G_KT + 4 * bg);
#pragma unroll
        for (int i = 0; i < G_RT; ++i) {
          const float x = lane4(a[i], kq);
          accr[i][0] = fmaf(x, br.x, accr[i][0]);
          accr[i][1] = fmaf(x, br.y, accr[i][1]);
          accr[i][2] = fmaf(x, br.z, accr[i][2]);
          accr[i][3] = fmaf(x, br.w, accr[i][3]);
          acci[i][0] = fmaf(x, bi.x, acci[i][0]);
          acci[i][1] = fmaf(x, bi.y, acci[i][1]);
          acci[i][2] = fmaf(x, bi.z, acci[i][2]);
          acci[i][3] = fmaf(x, bi.w, acci[i][3]);
        }
      }
    }
    if (nyq_row) {  // bin 512's chains over the chunk
      for (int k4 = 0; k4 < G_KC / 4; ++k4) {
        const float4 x = *reinterpret_cast<const float4*>(as + tid * G_AS + 4 * k4);
        const float4 b01 = *reinterpret_cast<const float4*>(bn + 8 * k4);
        const float4 b23 = *reinterpret_cast<const float4*>(bn + 8 * k4 + 4);
        nr = fmaf(x.x, b01.x, nr);
        ni = fmaf(x.x, b01.y, ni);
        nr = fmaf(x.y, b01.z, nr);
        ni = fmaf(x.y, b01.w, ni);
        nr = fmaf(x.z, b23.x, nr);
        ni = fmaf(x.z, b23.y, ni);
        nr = fmaf(x.w, b23.z, nr);
        ni = fmaf(x.w, b23.w, ni);
      }
    }
    if constexpr (DFT_BLOCKED) {
      if ((c + 1) % G_FOLD == 0) {           // a 128-sample chain ends here
#pragma unroll
        for (int i = 0; i < G_RT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            totr[i][j] = __fadd_rn(totr[i][j], accr[i][j]);
            toti[i][j] = __fadd_rn(toti[i][j], acci[i][j]);
            accr[i][j] = acci[i][j] = 0.f;
          }
        ntr = __fadd_rn(ntr, nr);
        nti = __fadd_rn(nti, ni);
        nr = ni = 0.f;
      }
    }
    __syncthreads();
    if (c + 2 < G_CHUNKS) load_chunk(c + 2);
  }
  if constexpr (DFT_BLOCKED) {
#pragma unroll
    for (int i = 0; i < G_RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        accr[i][j] = totr[i][j];
        acci[i][j] = toti[i][j];
      }
    nr = ntr;
    ni = nti;
  }

  // the tile's P over the stages: [plane][row][G_PS]
  float* pr = smem;
  float* pi = smem + G_PLANE;
#pragma unroll
  for (int i = 0; i < G_RT; ++i) {
    *reinterpret_cast<float4*>(pr + (rg + 16 * i) * G_PS + 4 * bg) =
        make_float4(accr[i][0], accr[i][1], accr[i][2], accr[i][3]);
    *reinterpret_cast<float4*>(pi + (rg + 16 * i) * G_PS + 4 * bg) =
        make_float4(acci[i][0], acci[i][1], acci[i][2], acci[i][3]);
  }
  if (nyq_row) {
    pr[tid * G_PS + G_KT] = nr;
    pi[tid * G_PS + G_KT] = ni;
  }
  __syncthreads();
  tile_outputs(pr, pi, dtab, table, nyq, tid, g0, total, nb, k0, uh, ul, fr, dsel, n_dist, twr,
               twi, xdr, xdi);
}

// Few-block form (forward_distance_few), for nb <= FEW_NB blocks a source:
// the live step's one block.  Its 8-16 sub-block rows leave the product
// form's 64-row tile almost empty, behind 8 CTAs that each stage 64 KB of
// the basis.  Here a thread owns one (bin, plane) pair and carries the
// chains of all R >= nb + 7 rows of its source, so a source spreads over
// 33 CTAs of one warp.  The CTA's 32 basis columns (16 KB) and the
// source's samples arrive by cp.async all at once, so the loads wait on L2
// once, not once a sample; then the samples broadcast from shared memory.
// Neighbouring lanes hold the re and im chains of one bin and swap them
// with one shuffle a row before the twiddle sum.  At one block the loads
// are most of its time: 64-thread CTAs (32 KB each) took 0.0080 ms, one
// warp 0.0064, and the sample loop unrolled 16 deep rather than 4 0.0073
// (PERF.md, launch A).
constexpr int F_THREADS = 32;
// R rows a thread fit where the static shared memory stays under 48 KB:
// R = 16 up to fpb 128, R = 8 up to 256; none above.
constexpr bool FEW16 = ALIGNED && Q <= 16 && sizeof(float) * FPB * (16 + F_THREADS) < 48 * 1024;
constexpr bool FEW8 = ALIGNED && Q <= 8 && sizeof(float) * FPB * (8 + F_THREADS) < 48 * 1024;
template <int R>
constexpr bool few_fits() {
  return R == 16 ? FEW16 : R == 8 ? FEW8 : false;
}
// most blocks a source: nb + Q - 1 <= R (9 at fpb 128 / pad 1024)
constexpr int FEW_NB = FEW16 ? 17 - Q : FEW8 ? 9 - Q : 0;

template <int R>  // sub-block rows a thread carries, R >= nb + 7
__global__ void __launch_bounds__(F_THREADS)
forward_distance_few(const float* __restrict__ streams, int nb,
                     const float* __restrict__ uh, const float* __restrict__ ul,
                     const float* __restrict__ fr, const int* __restrict__ dsel, int n_dist,
                     const float* __restrict__ cfr, const float* __restrict__ cfi,
                     const float* __restrict__ twr, const float* __restrict__ twi,
                     float* __restrict__ xdr, float* __restrict__ xdi) {
  __shared__ __align__(16) float xs[FPB * R];   // [sample][row]
  __shared__ float bs[FPB * F_THREADS];          // [sample][thread]: its basis column
  const int tid = threadIdx.x, s = blockIdx.y, L = nb + Q - 1;
  const int u = blockIdx.x * F_THREADS + tid;    // (bin, plane) pair
  const int k = min(u >> 1, BINS - 1);           // lanes past bin 512 repeat it, store nothing
  const int plane = u & 1;
  for (int i = tid; i < FPB * F_THREADS; i += F_THREADS) {
    const int n = i / F_THREADS, c = i % F_THREADS;
    const int kc = min((blockIdx.x * F_THREADS + c) >> 1, BINS - 1);
    cp_async4(&bs[i], ((c & 1) ? cfi : cfr) + (size_t)n * BINS + kc);
  }
  const float* src = streams + (size_t)s * L * FPB;
  for (int i = tid; i < FPB * R; i += F_THREADS) {
    const int r = i / FPB, n = i % FPB;
    if (r < L) cp_async4(&xs[n * R + r], src + i);
    else xs[n * R + r] = 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  auto chain = [&](int n0, int n1) {             // acc += samples n0 .. n1-1, ascending
#pragma unroll 16
    for (int n = n0; n < n1; ++n) {
      const float b = bs[n * F_THREADS + tid];
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 x = *reinterpret_cast<const float4*>(xs + n * R + 4 * r4);
        acc[4 * r4 + 0] = fmaf(x.x, b, acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(x.y, b, acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(x.z, b, acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(x.w, b, acc[4 * r4 + 3]);
      }
    }
  };
  if constexpr (DFT_BLOCKED) {
    float tot[R];                                // the 128-sample chains' sum
#pragma unroll
    for (int r = 0; r < R; ++r) tot[r] = 0.f;
    for (int n0 = 0; n0 < FPB; n0 += F_BLOCK) {
      chain(n0, n0 + F_BLOCK);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        tot[r] = __fadd_rn(tot[r], acc[r]);
        acc[r] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = tot[r];
  } else {
    chain(0, FPB);
  }
  float pr[R], pi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float other = __shfl_xor_sync(0xffffffffu, acc[r], 1);
    pr[r] = plane ? other : acc[r];
    pi[r] = plane ? acc[r] : other;
  }
  if (u >= 2 * BINS) return;
  float tr[Q], ti[Q];
#pragma unroll
  for (int m = 1; m < Q; ++m) {
    tr[m] = twr[m * BINS + k];
    ti[m] = twi[m * BINS + k];
  }
  const float kf = (float)k;
#pragma unroll
  for (int b = 0; b + Q <= R; ++b) {
    if (b < nb) {
      float wr[Q], wi[Q], xr, xi, dr, di, re, im;
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        wr[m] = pr[b + m];
        wi[m] = pi[b + m];
      }
      twiddle_sum(wr, wi, tr, ti, &xr, &xi);
      const int row = s * nb + b;
      const int t = triple_of(row, dsel, n_dist);
      distance_plane(uh[t], ul[t], fr[t], kf, &dr, &di);
      cmul_rn(xr, xi, dr, di, &re, &im);
      if (plane) xdi[(size_t)row * BINS + k] = im;
      else xdr[(size_t)row * BINS + k] = re;
    }
  }
}

// ---- launch A's planes form: any Q ------------------------------------------
//
// The other forms keep a window's Q sub-block DFTs on chip: the tile form
// its 32 + Q - 1 rows in shared memory and Q twiddles in registers, the
// product form Q - 1 of a tile's rows spent on the next tile's windows, the
// few-block form every row of a source in one thread.  Past Q 16 (tile), 64
// (product) and 16 (few) none of them fits: fpb 16 under pad 1024 is Q 64,
// fpb 2 is Q 512.  Here launch A is two launches through a scratch of the
// caller's (pr, pi: the total = S*(nb+Q-1) flat sub-block rows x BINS):
//   - subblock_planes writes each sub-block's DFT P once: a CTA per 32 flat
//     rows x 64 bins, samples and basis staged 32 at a time, each P[g, k]
//     the tile form's fmaf chain ascending from sample 0 (128-sample chains
//     summed in order above fpb 128);
//   - twiddle_distance runs the twiddle sum and the distance multiply per
//     (output, bin): a warp takes 32 bins, a thread V_RUN consecutive output
//     starts at one bin, m outer so that each twiddle is read once for the
//     run and each P row once (a window of V_RUN rows slides by one a step),
//     every output still summed m = 1 .. Q-1 ascending in twiddle_sum's op
//     order; P and the twiddles come through L2.
// So it gives the tile form's bits.  What bounds it: the twiddle sum's
// 8 (Q - 1) fp32 operations an output and bin (no FMA: each product rounds
// on its own), 23 GFLOP for 22,050 blocks at Q 256; the P reads, one 8-byte
// load a step for V_RUN outputs, stay under it.
constexpr int W_ROWS = 32;                    // flat sub-block rows a DFT tile
constexpr int W_KT = 64;                      // bins a DFT tile
constexpr int W_THREADS = 256;                // 64 bins x 4 row groups
constexpr int W_RPT = W_ROWS / (W_THREADS / W_KT);   // 8 rows a thread
constexpr int W_NC = FPB < 32 ? FPB : 32;     // samples staged at once
constexpr int V_RUN = 16;                     // output starts a thread
constexpr int V_KT = 32;                      // bins a warp
constexpr int V_THREADS = 128;                // 4 warps: 4 runs of one bin group
static_assert(!ALIGNED || FPB % W_NC == 0, "whole sample chunks");

template <int QT>  // = Q
__global__ void __launch_bounds__(W_THREADS)
subblock_planes(const float* __restrict__ streams, int total, const float* __restrict__ cfr,
                const float* __restrict__ cfi, float* __restrict__ pr, float* __restrict__ pi) {
  __shared__ float xs[W_ROWS][W_NC];
  __shared__ float bre[W_NC][W_KT], bim[W_NC][W_KT];
  const int g0 = blockIdx.x * W_ROWS, k0 = blockIdx.y * W_KT, tid = threadIdx.x;
  const int c = tid % W_KT, rg = tid / W_KT;
  float acc_r[W_RPT], acc_i[W_RPT], tot_r[W_RPT], tot_i[W_RPT];
#pragma unroll
  for (int i = 0; i < W_RPT; ++i) acc_r[i] = acc_i[i] = tot_r[i] = tot_i[i] = 0.f;
  for (int n0 = 0; n0 < FPB; n0 += W_NC) {
    for (int i = tid; i < W_ROWS * W_NC; i += W_THREADS) {
      const int r = i / W_NC, n = i % W_NC;
      xs[r][n] = g0 + r < total ? streams[(size_t)(g0 + r) * FPB + n0 + n] : 0.f;
    }
    for (int i = tid; i < W_NC * W_KT; i += W_THREADS) {
      const int n = i / W_KT, kk = i % W_KT, k = k0 + kk;
      bre[n][kk] = k < BINS ? cfr[(size_t)(n0 + n) * BINS + k] : 0.f;
      bim[n][kk] = k < BINS ? cfi[(size_t)(n0 + n) * BINS + k] : 0.f;
    }
    __syncthreads();
    for (int n = 0; n < W_NC; ++n) {
      const float br = bre[n][c], bi = bim[n][c];
#pragma unroll
      for (int i = 0; i < W_RPT; ++i) {
        const float x = xs[rg * W_RPT + i][n];
        acc_r[i] = fmaf(x, br, acc_r[i]);
        acc_i[i] = fmaf(x, bi, acc_i[i]);
      }
    }
    if (DFT_BLOCKED && (n0 + W_NC) % F_BLOCK == 0) {   // a 128-sample chain ends here
#pragma unroll
      for (int i = 0; i < W_RPT; ++i) {
        tot_r[i] = __fadd_rn(tot_r[i], acc_r[i]);
        tot_i[i] = __fadd_rn(tot_i[i], acc_i[i]);
        acc_r[i] = acc_i[i] = 0.f;
      }
    }
    __syncthreads();                        // the next chunk overwrites this one
  }
  const int k = k0 + c;
  if (k >= BINS) return;
#pragma unroll
  for (int i = 0; i < W_RPT; ++i) {
    const int g = g0 + rg * W_RPT + i;
    if (g < total) {
      pr[(size_t)g * BINS + k] = DFT_BLOCKED ? tot_r[i] : acc_r[i];
      pi[(size_t)g * BINS + k] = DFT_BLOCKED ? tot_i[i] : acc_i[i];
    }
  }
}

template <int QT>  // = Q
__global__ void __launch_bounds__(V_THREADS)
twiddle_distance(const float* __restrict__ pr, const float* __restrict__ pi, int total, int nb,
                 int bin_groups, const float* __restrict__ uh, const float* __restrict__ ul,
                 const float* __restrict__ fr, const int* __restrict__ dsel, int n_dist,
                 const float* __restrict__ twr, const float* __restrict__ twi,
                 float* __restrict__ xdr, float* __restrict__ xdi) {
  // bin groups and runs share the grid's x (its y holds 65,535 CTAs at most)
  const int kg = blockIdx.x % bin_groups;
  const int run = (blockIdx.x / bin_groups) * (V_THREADS / V_KT) + threadIdx.x / V_KT;
  const int k = kg * V_KT + threadIdx.x % V_KT;
  const int starts = total - (QT - 1);      // flat output starts; a source's last Q-1 are gaps
  const int g0 = run * V_RUN;
  if (k >= BINS || g0 >= starts) return;
  auto p = [&](const float* plane, int g) { return g < total ? plane[(size_t)g * BINS + k] : 0.f; };
  float xr[V_RUN], xi[V_RUN], wr[V_RUN], wi[V_RUN];
#pragma unroll
  for (int o = 0; o < V_RUN; ++o) {         // m = 0: X = P[g]
    xr[o] = wr[o] = p(pr, g0 + o);
    xi[o] = wi[o] = p(pi, g0 + o);
  }
#pragma unroll 2
  for (int m = 1; m < QT; ++m) {            // wr[o] = P[g0 + o + m]
    const float a = twr[(size_t)m * BINS + k], b = twi[(size_t)m * BINS + k];
#pragma unroll
    for (int o = 0; o + 1 < V_RUN; ++o) {
      wr[o] = wr[o + 1];
      wi[o] = wi[o + 1];
    }
    wr[V_RUN - 1] = p(pr, g0 + V_RUN - 1 + m);
    wi[V_RUN - 1] = p(pi, g0 + V_RUN - 1 + m);
#pragma unroll
    for (int o = 0; o < V_RUN; ++o) {       // twiddle_sum's op order
      xr[o] = __fadd_rn(xr[o], __fsub_rn(__fmul_rn(a, wr[o]), __fmul_rn(b, wi[o])));
      xi[o] = __fadd_rn(xi[o], __fadd_rn(__fmul_rn(a, wi[o]), __fmul_rn(b, wr[o])));
    }
  }
  const int L = nb + QT - 1;
  const float kf = (float)k;
#pragma unroll
  for (int o = 0; o < V_RUN; ++o) {
    const int g = g0 + o, s = g / L, j = g - s * L;
    if (g < starts && j < nb) {
      const int row = s * nb + j;
      const int t = triple_of(row, dsel, n_dist);
      float dr, di;
      distance_plane(uh[t], ul[t], fr[t], kf, &dr, &di);
      cmul_rn(xr[o], xi[o], dr, di, &xdr[(size_t)row * BINS + k], &xdi[(size_t)row * BINS + k]);
    }
  }
}

// ---- launch A's ring form: past Q 16, one launch ---------------------------
//
// What held the planes form back (PERF.md, the ring form): twiddle_distance sums
// every flat start, the Q - 1 that straddle two sources too (48% of its
// work at fpb 4, 16 x 256; 79% at 16 x 64); P goes to a scratch and back
// through L2, each row read once a V_RUN outputs; its window moves by
// register copies; and bin 512 holds a group of 32 lanes alone.  Here a CTA
// (forward_distance_ring) takes one source's run of T consecutive output
// blocks and a slice of R_KT = 32 bins (the last slice also bin 512), so
// its windows never leave the source, and computes P itself into a
// shared-memory ring of RING rows as it goes: m runs in chunks of R_MC, and
// before chunk c the CTA computes the P rows chunk c reads first (rows 0 ..
// R_MC + T - 2 for chunk 0, then R_MC more a chunk; the run's Q - 1 halo
// rows are computed again by the next run's CTA, 2 fpb FMAs a row and bin
// against the 8 (Q - 1) operations of each output) and stages the chunk's
// twiddles, all by cp.async.  So any Q runs in the same shared memory.  A
// thread holds V consecutive outputs at one bin and walks m ascending; its
// window of V P values is a ring of registers indexed (u + o) % V, m
// unrolled by V, so a step is one P load and one twiddle load from shared
// memory for 8 V operations and no register moves.  The run T = V x RUNS
// is 128 blocks where the grid fills the card, narrower where it does not
// (ring_shape).  The bits are the planes form's: each P[g, k] is the same
// fmaf chain ascending from sample 0 (128-sample chains summed in order
// above fpb 128), each output's twiddle sum the same ops in the same order
// (twiddle_sum), then the same distance plane (the triple table of the
// product form when n_dist <= D_UNIQ: the same function of triple and bin)
// and cmul_rn.  What bounds it: the twiddle sum's 8 (Q - 1) fp32
// operations an output and bin, each its own instruction (no FMA), over
// 132 SMs x 128 lanes a clock; then the P build (its halo rows) and the
// distance planes (precise cosf/sinf, per row).
constexpr int R_KT = 32;                      // bins a slice: a warp's lanes
constexpr int R_MC = Q < 32 ? Q : 32;         // m a chunk
constexpr int R_DR = 32;                      // P rows a DFT block
constexpr int R_NC = FPB < 16 ? FPB : 16;     // samples staged at once
constexpr bool R_VEC = R_NC % 4 == 0;         // a row's samples read 4 at a time
// padded sample row (16-byte rows where read 4 at a time): bin 512's chains
// read down it
constexpr int R_XS = R_VEC ? R_NC + 4 : R_NC + 1;
constexpr bool R_NYQ = (BINS - 1) % R_KT == 0;   // bin BINS-1 rides with the last slice
constexpr int R_SLICES = R_NYQ ? (BINS - 1) / R_KT : (BINS + R_KT - 1) / R_KT;
constexpr int R_PS = R_KT + 1;                // float2s a ring or twiddle row: the slice, bin 512
constexpr int R_WAVE = 132;                   // the H100's SMs: a V = 16 grid this large
constexpr bool HAS_RING = ALIGNED && Q > TILE_MAX_Q;   // where the tile form does not exist
// The steps take the ring form up to fpb 32 at every shape, where it
// measured faster than the planes form at every shape (fpb 2, 4, 16, 32).
// Past fpb 32 its sub-block DFTs, built again for each run's halo rows,
// grow with fpb, and it won only where the planes form throws much away
// (ring_pays; kernels/fused_step.py RING_MAX_FPB has the readings).
constexpr int RING_MAX_FPB = 32;

// Whether the steps take the ring form at S sources x nb blocks where it
// exists: up to RING_MAX_FPB always; past it where fpb <= Q and the planes
// form's sums that straddle two sources, (S - 1)(Q - 1), are at least half
// of its S nb outputs.
inline bool ring_pays(int num_sources, int nb) {
  return FPB <= RING_MAX_FPB ||
         (FPB <= Q && 2LL * (num_sources - 1) * (Q - 1) >= (long long)num_sources * nb);
}
static_assert(!HAS_RING || (Q % R_MC == 0 && R_MC % 16 == 0), "whole chunks of m");
static_assert(!ALIGNED || FPB % R_NC == 0, "whole sample chunks");

constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// V outputs a thread, RUNS runs of them down each bin of the slice,
// MIN_CTAS CTAs an SM (their registers and shared memory fit).
template <int V_, int RUNS_, int MIN_CTAS_>
struct Ring {
  static constexpr int V = V_, RUNS = RUNS_, MIN_CTAS = MIN_CTAS_;
  static constexpr int THREADS = RUNS * R_KT;
  static constexpr int T = V * RUNS;                           // output blocks a CTA
  static constexpr int DRT = R_DR / RUNS;                      // DFT rows a thread
  static constexpr int RING = pow2_at_least(R_MC + T - 1);     // P rows the ring holds
  static constexpr int RING_F = 2 * RING * R_PS;               // floats: [row][R_PS] float2
  static constexpr int TW_F = 2 * R_MC * R_PS;                 // a chunk's twiddles
  static constexpr int XS_F = R_DR * R_XS;                     // a block's samples
  static constexpr int BS_F = 2 * R_NC * R_PS;                 // the basis slice's samples
  static constexpr int DT_F = 2 * D_UNIQ * R_PS;               // the triples' distance planes
  static constexpr size_t SMEM = sizeof(float) * (RING_F + TW_F + XS_F + BS_F + DT_F);
  static_assert(!HAS_RING || ((RING_F + TW_F) % 4 == 0 && XS_F % 4 == 0), "16-byte rows");
  static_assert(!HAS_RING || SMEM + 1024 <= 232448 / MIN_CTAS, "MIN_CTAS CTAs an SM");
};
// The shapes the launch picks among (ring_shape), by the CTA's run T:
// 128 blocks (16 outputs x 8 runs, 127 registers, two CTAs an SM), 64 (8 x
// 8, three), 16 (4 x 4, four) and 4 (1 x 4, four).  Against 16 x 4 (T 64,
// four CTAs, 128 registers with spills) at fpb 4, 16 x 256, device time
// alone: 0.1983 / 0.2102 / 0.2566 ms; at 16 x 64, where a T-128 CTA's
// second half is idle, T 64 0.0605, T 128 0.1056; at 3 x 88 and 1 x 1 the
// narrow shapes (H100, 700 W; PERF.md, the ring form).
using Ring128 = Ring<16, 8, 2>;
using Ring64 = Ring<8, 8, 3>;
using Ring16 = Ring<4, 4, 4>;
using Ring4 = Ring<1, 4, 4>;

std::atomic<unsigned long long> ring_smem_set[4];   // by shape

template <class R>
__global__ void __launch_bounds__(R::THREADS, R::MIN_CTAS)
forward_distance_ring(const float* __restrict__ streams, int nb, int tiles,
                      const float* __restrict__ uh, const float* __restrict__ ul,
                      const float* __restrict__ fr, const int* __restrict__ dsel, int n_dist,
                      const float* __restrict__ cfr, const float* __restrict__ cfi,
                      const float* __restrict__ twr, const float* __restrict__ twi,
                      float* __restrict__ xdr, float* __restrict__ xdi) {
  constexpr int V = R::V, T = R::T, RM = R::RING - 1, NT = R::THREADS, DRT = R::DRT;
  extern __shared__ __align__(16) float smem[];
  float2* ring = reinterpret_cast<float2*>(smem);                  // [RING][R_PS]
  float2* tw = reinterpret_cast<float2*>(smem + R::RING_F);        // [R_MC][R_PS]
  float* xs = smem + R::RING_F + R::TW_F;                          // [R_DR][R_XS]
  float2* bs = reinterpret_cast<float2*>(xs + R::XS_F);            // [R_NC][R_PS]
  float* dtab = xs + R::XS_F + R::BS_F;                            // [plane][triple][R_PS]

  const int slice = blockIdx.x % R_SLICES;
  const int tile = (blockIdx.x / R_SLICES) % tiles;
  const int s = blockIdx.x / R_SLICES / tiles;
  const int k0 = slice * R_KT, j0 = tile * T;
  const bool nyq = R_NYQ && slice == R_SLICES - 1;
  const int tid = threadIdx.x, col = tid % R_KT, run = tid / R_KT;
  const int nv = nb + Q - 1 - j0;                       // rows of the source from j0
  const float* src = streams + ((size_t)s * (nb + Q - 1) + j0) * FPB;

  const bool table = dsel != nullptr && n_dist <= D_UNIQ;
  if (table) {
    for (int i = tid; i < n_dist * R_PS; i += NT) {
      const int t = i / R_PS, c = i % R_PS;
      const int k = c < R_KT ? k0 + c : BINS - 1;
      if ((c < R_KT && k < BINS) || (c == R_KT && nyq))
        distance_plane(uh[t], ul[t], fr[t], (float)k, &dtab[t * R_PS + c],
                       &dtab[(D_UNIQ + t) * R_PS + c]);
    }
  }

  // P rows [ra, hi) (ra + R_DR or fewer) of the run into the ring: thread
  // (run, col) holds rows run*DRT + i of the block at bin k0 + col, warp 0
  // also bin 512's row tid in the last slice
  auto dft_block = [&](int ra, int hi) {
    float ar[DRT], ai[DRT], tr_[DFT_BLOCKED ? DRT : 1], ti_[DFT_BLOCKED ? DRT : 1];
    float nr = 0.f, ni = 0.f, ntr = 0.f, nti = 0.f;
#pragma unroll
    for (int i = 0; i < DRT; ++i) ar[i] = ai[i] = 0.f;
    if constexpr (DFT_BLOCKED) {
#pragma unroll
      for (int i = 0; i < DRT; ++i) tr_[i] = ti_[i] = 0.f;
    }
    for (int n0 = 0; n0 < FPB; n0 += R_NC) {
      for (int i = tid; i < R_DR * R_NC; i += NT) {
        const int r = i / R_NC, n = i % R_NC;
        if (ra + r < nv) cp_async4(xs + r * R_XS + n, src + (size_t)(ra + r) * FPB + n0 + n);
        else xs[r * R_XS + n] = 0.f;
      }
      for (int i = tid; i < R_NC * R_PS; i += NT) {
        const int n = i / R_PS, c = i % R_PS;
        const int k = c < R_KT ? k0 + c : BINS - 1;
        float* dst = reinterpret_cast<float*>(bs + i);
        if ((c < R_KT && k < BINS) || (c == R_KT && nyq)) {
          cp_async4(dst, cfr + (size_t)(n0 + n) * BINS + k);
          cp_async4(dst + 1, cfi + (size_t)(n0 + n) * BINS + k);
        } else {
          dst[0] = dst[1] = 0.f;
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (R_VEC) {                 // each sample chain still ascends one n at a time
#pragma unroll 2
        for (int n4 = 0; n4 < R_NC; n4 += 4) {
          float4 x[DRT];
#pragma unroll
          for (int i = 0; i < DRT; ++i)
            x[i] = *reinterpret_cast<const float4*>(xs + (run * DRT + i) * R_XS + n4);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 b = bs[(n4 + q) * R_PS + col];
#pragma unroll
            for (int i = 0; i < DRT; ++i) {
              const float xv = lane4(x[i], q);
              ar[i] = fmaf(xv, b.x, ar[i]);
              ai[i] = fmaf(xv, b.y, ai[i]);
            }
          }
        }
      } else {
        for (int n = 0; n < R_NC; ++n) {
          const float2 b = bs[n * R_PS + col];
#pragma unroll
          for (int i = 0; i < DRT; ++i) {
            const float xv = xs[(run * DRT + i) * R_XS + n];
            ar[i] = fmaf(xv, b.x, ar[i]);
            ai[i] = fmaf(xv, b.y, ai[i]);
          }
        }
      }
      if (nyq && tid < R_DR) {
        for (int n = 0; n < R_NC; ++n) {
          const float2 b = bs[n * R_PS + R_KT];
          const float xv = xs[tid * R_XS + n];
          nr = fmaf(xv, b.x, nr);
          ni = fmaf(xv, b.y, ni);
        }
      }
      if constexpr (DFT_BLOCKED) {
        if ((n0 + R_NC) % F_BLOCK == 0) {    // a 128-sample chain ends here
#pragma unroll
          for (int i = 0; i < DRT; ++i) {
            tr_[i] = __fadd_rn(tr_[i], ar[i]);
            ti_[i] = __fadd_rn(ti_[i], ai[i]);
            ar[i] = ai[i] = 0.f;
          }
          ntr = __fadd_rn(ntr, nr);
          nti = __fadd_rn(nti, ni);
          nr = ni = 0.f;
        }
      }
      __syncthreads();                       // the next chunk overwrites this one
    }
#pragma unroll
    for (int i = 0; i < DRT; ++i) {
      const int r = ra + run * DRT + i;
      if (r < hi)
        ring[(r & RM) * R_PS + col] =
            DFT_BLOCKED ? make_float2(tr_[i], ti_[i]) : make_float2(ar[i], ai[i]);
    }
    if (nyq && tid < R_DR && ra + tid < hi)
      ring[((ra + tid) & RM) * R_PS + R_KT] = DFT_BLOCKED ? make_float2(ntr, nti)
                                                          : make_float2(nr, ni);
  };

  const int rb = run * V;                    // this thread's first output in the run
  float xr[V], xi[V], wr[V], wi[V];          // wr[(row) % V] = P[rb + row], row < V + m - 1
  float xnr = 0.f, xni = 0.f;                // bin 512 of output tid (tid < T)
  for (int c0 = 0; c0 < Q; c0 += R_MC) {
    // the chunk's twiddles m = c0 .. c0 + R_MC - 1 (joined to the first
    // block's group), then the P rows it reads first
    for (int i = tid; i < R_MC * R_PS; i += NT) {
      const int u = i / R_PS, c = i % R_PS;
      const int k = c < R_KT ? k0 + c : BINS - 1;
      float* dst = reinterpret_cast<float*>(tw + i);
      if ((c < R_KT && k < BINS) || (c == R_KT && nyq)) {
        cp_async4(dst, twr + (size_t)(c0 + u) * BINS + k);
        cp_async4(dst + 1, twi + (size_t)(c0 + u) * BINS + k);
      } else {
        dst[0] = dst[1] = 0.f;
      }
    }
    const int lo = c0 == 0 ? 0 : c0 + T - 1, hi = c0 + R_MC + T - 1;
    for (int ra = lo; ra < hi; ra += R_DR) dft_block(ra, min(ra + R_DR, hi));
    __syncthreads();                         // the ring's new rows
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i + 1 < V; ++i) {
        const float2 p = ring[((rb + i) & RM) * R_PS + col];
        wr[i] = p.x;
        wi[i] = p.y;
      }
    }
    for (int mb = c0; mb < c0 + R_MC; mb += V) {
      const float2* twm = tw + (mb - c0) * R_PS + col;
#pragma unroll
      for (int u = 0; u < V; ++u) {          // m = mb + u; slot (u + o) % V holds P[rb + o + m]
        const float2 p = ring[((rb + mb + u + V - 1) & RM) * R_PS + col];
        wr[(u + V - 1) % V] = p.x;
        wi[(u + V - 1) % V] = p.y;
        if (u == 0 && mb == 0) {             // m = 0: X = P
#pragma unroll
          for (int o = 0; o < V; ++o) {
            xr[o] = wr[o];
            xi[o] = wi[o];
          }
        } else {
          const float2 t = twm[u * R_PS];
#pragma unroll
          for (int o = 0; o < V; ++o) {      // twiddle_sum's op order
            const int w = (u + o) % V;
            xr[o] = __fadd_rn(xr[o], __fsub_rn(__fmul_rn(t.x, wr[w]), __fmul_rn(t.y, wi[w])));
            xi[o] = __fadd_rn(xi[o], __fadd_rn(__fmul_rn(t.x, wi[w]), __fmul_rn(t.y, wr[w])));
          }
        }
      }
    }
    if (nyq && tid < T) {
      for (int m = c0; m < c0 + R_MC; ++m) {
        const float2 p = ring[((tid + m) & RM) * R_PS + R_KT];
        if (m == 0) {
          xnr = p.x;
          xni = p.y;
        } else {
          const float2 t = tw[(m - c0) * R_PS + R_KT];
          xnr = __fadd_rn(xnr, __fsub_rn(__fmul_rn(t.x, p.x), __fmul_rn(t.y, p.y)));
          xni = __fadd_rn(xni, __fadd_rn(__fmul_rn(t.x, p.y), __fmul_rn(t.y, p.x)));
        }
      }
    }
    __syncthreads();                         // the next chunk overwrites the ring and twiddles
  }

  const float* dti = dtab + D_UNIQ * R_PS;
  const int k = k0 + col;
  if (k < BINS) {
#pragma unroll
    for (int o = 0; o < V; ++o) {
      const int j = j0 + rb + o;
      if (j < nb) {
        const int row = s * nb + j;
        const int d = triple_of(row, dsel, n_dist);
        float dr, di;
        if (table) {
          dr = dtab[d * R_PS + col];
          di = dti[d * R_PS + col];
        } else {
          distance_plane(uh[d], ul[d], fr[d], (float)k, &dr, &di);
        }
        cmul_rn(xr[o], xi[o], dr, di, &xdr[(size_t)row * BINS + k], &xdi[(size_t)row * BINS + k]);
      }
    }
  }
  if (nyq && tid < T && j0 + tid < nb) {
    const int row = s * nb + j0 + tid;
    const int d = triple_of(row, dsel, n_dist);
    float dr, di;
    if (table) {
      dr = dtab[d * R_PS + R_KT];
      di = dti[d * R_PS + R_KT];
    } else {
      distance_plane(uh[d], ul[d], fr[d], (float)(BINS - 1), &dr, &di);
    }
    cmul_rn(xnr, xni, dr, di, &xdr[(size_t)row * BINS + BINS - 1],
            &xdi[(size_t)row * BINS + BINS - 1]);
  }
}

// The ring form over num_sources streams of nb blocks in shape R (refused
// where the geometry has no ring form).
template <class R, int SLOT>
cudaError_t launch_ring(cudaStream_t stream, const float* streams, int num_sources, int nb,
                        const float* uh, const float* ul, const float* fr, const int* dsel,
                        int n_dist, const float* cfr, const float* cfi, const float* twr,
                        const float* twi, float* xdr, float* xdi) {
  if constexpr (HAS_RING) {
    const cudaError_t err =
        allow_smem_once(forward_distance_ring<R>, R::SMEM, ring_smem_set[SLOT]);
    if (err != cudaSuccess) return err;
    const int tiles = (nb + R::T - 1) / R::T;
    const long long ctas = (long long)R_SLICES * tiles * num_sources;
    if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
    forward_distance_ring<R><<<(unsigned)ctas, R::THREADS, R::SMEM, stream>>>(
        streams, nb, tiles, uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
    return cudaSuccess;
  } else {
    return cudaErrorInvalidValue;
  }
}

// The ring form's run at S sources x nb blocks: 128 blocks where a source
// fills one and that grid holds a CTA an SM, else the widest of 64, 16
// whose grid does, else 4: the outputs a thread carries only lengthen a
// small grid's one wave.
inline int ring_shape(int num_sources, int nb) {
  auto ctas = [&](int t) { return (long long)num_sources * ((nb + t - 1) / t) * R_SLICES; };
  return nb >= Ring128::T && ctas(Ring128::T) >= R_WAVE ? Ring128::T
         : ctas(Ring64::T) >= R_WAVE                    ? Ring64::T
         : ctas(Ring16::T) >= R_WAVE                    ? Ring16::T
                                                        : Ring4::T;
}

// Launch A's forms.  FWD_TILE: forward_distance, one CTA per 32 blocks x
// 64 bins of a source, kept as the comparison form; FWD_PRODUCT, FWD_FEW,
// FWD_PLANES and FWD_RING as above.  All five give the same bits.
// FWD_PLANES_DFT and FWD_PLANES_SUM are the planes form's two launches
// alone (subblock_planes into pr, pi; twiddle_distance from them), for
// timing each apart.
enum ForwardForm {
  FWD_TILE = 0, FWD_PRODUCT = 1, FWD_FEW = 2, FWD_PLANES = 3, FWD_RING = 4,
  FWD_PLANES_DFT = 5, FWD_PLANES_SUM = 6
};

// The form the render steps take at S sources x nb blocks
// (kernels/fused_step.forward_form mirrors it): the few-block form up to
// FEW_NB, else the product form where the geometry has it, else the tile
// form where it has that, else the ring form where it pays, else the
// planes form.
inline int forward_form(int num_sources, int nb) {
  return nb <= FEW_NB                  ? FWD_FEW
         : HAS_PRODUCT                 ? FWD_PRODUCT
         : HAS_TILE                    ? FWD_TILE
         : ring_pays(num_sources, nb) ? FWD_RING
                                       : FWD_PLANES;
}

template <int R>
cudaError_t launch_few(cudaStream_t stream, const float* streams, int num_sources, int nb,
                       const float* uh, const float* ul, const float* fr, const int* dsel,
                       int n_dist, const float* cfr, const float* cfi, const float* twr,
                       const float* twi, float* xdr, float* xdi) {
  if constexpr (few_fits<R>()) {
    const dim3 grid((2 * BINS + F_THREADS - 1) / F_THREADS, num_sources);
    forward_distance_few<R><<<grid, F_THREADS, 0, stream>>>(streams, nb, uh, ul, fr, dsel,
                                                            n_dist, cfr, cfi, twr, twi, xdr, xdi);
    return cudaSuccess;
  } else {
    return cudaErrorInvalidValue;
  }
}

// Launch A in ``form`` over num_sources streams of nb blocks each (rows =
// num_sources*nb); pr and pi are the planes form's scratch (num_sources *
// (nb + Q - 1) rows x BINS each; null for the other forms; FWD_PLANES_SUM
// reads the DFTs FWD_PLANES_DFT wrote there).  Anything else, a form the
// geometry lacks, FWD_FEW above FEW_NB blocks, the planes form without its
// scratch, or a history of partial blocks, is refused
// (cudaErrorInvalidValue).
inline cudaError_t launch_forward_form(
    int form, cudaStream_t stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi, float* pr, float* pi) {
  if constexpr (!ALIGNED) {
    return cudaErrorInvalidValue;
  } else {
    cudaError_t err = cudaSuccess;
    const int total = num_sources * (nb + Q - 1);   // flat sub-block rows
    if (form == FWD_TILE) {
      if constexpr (HAS_TILE) {
        err = allow_smem_once(forward_distance<Q>, A_SMEM, tile_smem_set);
        if (err != cudaSuccess) return err;
        const dim3 grid((nb + A_BT - 1) / A_BT, (BINS + A_KT - 1) / A_KT, num_sources);
        forward_distance<Q><<<grid, A_THREADS, A_SMEM, stream>>>(
            streams, nb, uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi);
      } else {
        return cudaErrorInvalidValue;
      }
    } else if (form == FWD_PRODUCT) {
      if constexpr (HAS_PRODUCT) {
        const bool vec = reinterpret_cast<size_t>(streams) % 16 == 0;
        auto kernel = vec ? forward_distance_product<true> : forward_distance_product<false>;
        err = allow_smem_once(kernel, G_SMEM, product_smem_set[vec]);
        if (err != cudaSuccess) return err;
        const dim3 grid((total - (Q - 1) + G_OUT - 1) / G_OUT, G_SLICES);
        kernel<<<grid, G_THREADS, G_SMEM, stream>>>(streams, num_sources, nb, uh, ul, fr, dsel,
                                                    n_dist, cfr, cfi, twr, twi, xdr, xdi);
      } else {
        return cudaErrorInvalidValue;
      }
    } else if (form == FWD_FEW && nb <= FEW_NB) {
      err = nb + Q - 1 <= 8 ? launch_few<8>(stream, streams, num_sources, nb, uh, ul, fr, dsel,
                                            n_dist, cfr, cfi, twr, twi, xdr, xdi)
                            : launch_few<16>(stream, streams, num_sources, nb, uh, ul, fr, dsel,
                                             n_dist, cfr, cfi, twr, twi, xdr, xdi);
      if (err != cudaSuccess) return err;
    } else if ((form == FWD_PLANES || form == FWD_PLANES_DFT || form == FWD_PLANES_SUM) && pr &&
               pi) {
      if (form != FWD_PLANES_SUM) {
        const dim3 pgrid((total + W_ROWS - 1) / W_ROWS, (BINS + W_KT - 1) / W_KT);
        subblock_planes<Q><<<pgrid, W_THREADS, 0, stream>>>(streams, total, cfr, cfi, pr, pi);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
      if (form != FWD_PLANES_DFT) {
        const int bin_groups = (BINS + V_KT - 1) / V_KT;
        const int runs = (total - (Q - 1) + V_RUN - 1) / V_RUN;
        const int run_groups = (runs + V_THREADS / V_KT - 1) / (V_THREADS / V_KT);
        twiddle_distance<Q><<<(unsigned)run_groups * bin_groups, V_THREADS, 0, stream>>>(
            pr, pi, total, nb, bin_groups, uh, ul, fr, dsel, n_dist, twr, twi, xdr, xdi);
      }
    } else if (form == FWD_RING && HAS_RING) {
#define JT_RING(R, SLOT) launch_ring<R, SLOT>(stream, streams, num_sources, nb, uh, ul, fr, dsel, \
                                             n_dist, cfr, cfi, twr, twi, xdr, xdi)
      const int t = ring_shape(num_sources, nb);
      err = t == Ring128::T ? JT_RING(Ring128, 0)
            : t == Ring64::T ? JT_RING(Ring64, 1)
            : t == Ring16::T ? JT_RING(Ring16, 2)
                             : JT_RING(Ring4, 3);
#undef JT_RING
      if (err != cudaSuccess) return err;
    } else {
      return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }
}

// Launch A as the render steps take it: forward_form(num_sources, nb).
inline cudaError_t launch_forward_distance(
    cudaStream_t stream, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi, float* pr, float* pi) {
  return launch_forward_form(forward_form(num_sources, nb), stream, streams, num_sources, nb,
                             uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi, pr, pi);
}

// The first output column of this CTA's t-tile.
__device__ __forceinline__ int tile_t0() { return T_TILES == 1 ? 0 : (int)blockIdx.y * TT; }

// Stage the (T_KC x TT) tail-basis chunk that starts at bin k0, columns
// t0 .. t0 + TT - 1 (0 past BINS or FPB).
__device__ __forceinline__ void load_tail_basis(float* br, float* bi,
                                                const float* __restrict__ icr,
                                                const float* __restrict__ ici,
                                                int k0, int t0, int tid, int nthreads) {
  for (int i = tid; i < T_KC * TT; i += nthreads) {
    const int k = k0 + i / TT, t = t0 + i % TT;
    const bool ok = k < BINS && (!B_MASK || t < FPB);
    br[i] = ok ? icr[(size_t)k * FPB + t] : 0.f;
    bi[i] = ok ? ici[(size_t)k * FPB + t] : 0.f;
  }
}

// N floats of shared memory at p (16-byte aligned for N a multiple of 4,
// 8-byte for N = 2) into a, in 16-, 8- or 4-byte loads.
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float* a) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      a[i] = x.x;
      a[i + 1] = x.y;
      a[i + 2] = x.z;
      a[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    a[0] = x.x;
    a[1] = x.y;
  } else {
    static_assert(N == 1, "1, 2 or a multiple of 4 floats");
    a[0] = p[0];
  }
}

// Where the tile fits the block, launch B's basis chunk is whole basis rows,
// one run of T_KC * FPB floats a plane: started by cp.async (16-byte
// copies, 4-byte at fpb 2; rows past BINS zero) before the chunk's q build,
// so the copy lands during it and holds no registers; the caller waits
// (cp_async_wait<0>) before its barrier.  (Copied synchronously after the
// q build, load_tail_basis's way or in float4s, rows 2-4 and 8 took up to
// 1.6x as long at fpb 64 on an H100: PERF.md, PR 18.)
__device__ __forceinline__ void start_fit_basis(float* br, float* bi,
                                                const float* __restrict__ icr,
                                                const float* __restrict__ ici, int k0, int tid,
                                                int nthreads) {
  constexpr int V = FPB % 4 == 0 ? 4 : 1, PLANE = T_KC * FPB / V;
  const int n = (BINS - k0 < T_KC ? BINS - k0 : T_KC) * FPB;   // floats of rows < BINS
  for (int i = tid; i < 2 * PLANE; i += nthreads) {
    const int j = (i % PLANE) * V;
    float* d = (i < PLANE ? br : bi) + j;
    const float* src = (i < PLANE ? icr : ici) + (size_t)k0 * FPB + j;
    if (j >= n) {
      for (int v = 0; v < V; ++v) d[v] = 0.f;
    } else if constexpr (V == 4) {
      cp_async16(d, src);
    } else {
      cp_async4(d, src);
    }
  }
  cp_async_commit();
}

// Launch B's rows a CTA: 32, or 16 where the tile fits a smaller block
// (twice the CTAs, each with half the q build and FMA loop: a small grid
// spreads over more SMs, a large one holds two CTAs an SM where it held one).
constexpr int B_ROWS = T_FIT ? 16 : 32;

// Launch B's register tile over an (M x T_COLS) output tile at 2M threads:
// TX threads along the columns, each RI operand rows ty*RI + i by CJ
// columns col(tx, j) = (j / VW) * (T_COLS / G) + VW * tx + j % VW, read as
// G vectors of VW.  At TT columns 16 x 8 x 8 in scalars (columns tx + 16j).
// Fitted to a smaller block, 8 columns a thread (fewer below fpb 16), read
// in float4s, and TX / 2 rows.
struct TailTile {
  static constexpr int CJ = !T_FIT ? 8 : T_COLS / 2 < 8 ? T_COLS / 2 : 8;
  static constexpr int TX = T_COLS / CJ;
  static constexpr int RI = TX / 2;
  static constexpr int VW = !T_FIT ? 1 : CJ < 4 ? CJ : 4;
  static constexpr int G = CJ / VW;
  __device__ static int col(int tx, int j) { return (j / VW) * (T_COLS / G) + VW * tx + j % VW; }
};

// acc[i][j] += sum over the chunk's bins of qr*br + qi*bi for operand row
// ty*RI+i and output column TailTile::col(tx, j), bins in ascending order:
// each output element accumulates the same sequence whatever the operand's
// height.
__device__ __forceinline__ void tail_chunk_fma(float (&acc)[TailTile::RI][TailTile::CJ],
                                               const float* qr, const float* qi,
                                               const float* br, const float* bi, int tx,
                                               int ty) {
  constexpr int RI = TailTile::RI, CJ = TailTile::CJ, VW = TailTile::VW, G = TailTile::G;
  for (int kk = 0; kk < T_KC; ++kk) {
    float ar[RI], ai[RI], vr[CJ], vi[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      ar[i] = qr[(ty * RI + i) * T_QS + kk];
      ai[i] = qi[(ty * RI + i) * T_QS + kk];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load_floats<VW>(br + kk * T_COLS + g * (T_COLS / G) + VW * tx, vr + g * VW);
      load_floats<VW>(bi + kk * T_COLS + g * (T_COLS / G) + VW * tx, vi + g * VW);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
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
__device__ __forceinline__ bool ends_tail_block(int k0) {
  return (k0 + T_KC) % T_BLOCK == 0 || k0 + T_KC >= BINS;
}

__device__ __forceinline__ void fold_tail_block(float (&acc)[TailTile::RI][TailTile::CJ],
                                                float (&part)[TailTile::RI][TailTile::CJ]) {
#pragma unroll
  for (int i = 0; i < TailTile::RI; ++i)
#pragma unroll
    for (int j = 0; j < TailTile::CJ; ++j) {
      acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
      part[i][j] = 0.f;
    }
}

// ---- launch B's split form: a cluster of CTAs per tile, one per block ----
//
// The blocked tail is NBLK independent chains per output, one per 128-bin
// block, folded in order: (((0 + p0) + p1) + ...) + p_last, then the last
// bin's chain fmaf(qi, bi, fmaf(qr, br, 0)).  Launch B walks them one after
// another in one CTA; here the ranks of a tile's cluster walk the blocks
// apart, so a CTA holds one 8 x 8 accumulator tile a block (launch B holds
// two) and folds its share of the tile's rows over distributed shared
// memory in block order.  Per tile:
//   - its filter rows are staged once: old rows r0 .. r0+R (the new side of
//     row r inside a segment is old row r+1) and each segment end's
//     boundary row, pre-blended (rows 5-7) or blended here with launch B's
//     4-bracket code (rows 2-4, 8), so every G keeps its bits;
//   - q (XD times G, per side and ear) lies bin-major with a padded stride,
//     so a thread's operand rows are float4 loads, and each thread owns 4
//     consecutive output columns per float4 of the basis; each output still
//     sums fmaf(qr, br) then fmaf(qi, bi) over ascending k from 0, as
//     tail_chunk_fma does;
//   - the basis arrives in chunks of 32 bins (8 in the pipelined layout)
//     by cp.async, the next chunk in flight while this one is multiplied
//     (16-byte copies where fpb % 4 == 0, else 4-byte copies: rows of fpb
//     floats);
//   - each rank stores its block partials in its own shared memory; after
//     cluster.sync() rank b folds rows b*FOLD .. of the tile in block order,
//     adds the last bin's chain (launch B's code), runs launch B's epilogue
//     and writes its rows.
// So the result is launch B's bit for bit.  Reusing staged row r+1 as row
// r's new side needs group ends on segment ends (the wrapper checks).
//
// Layouts with the same bits, chosen at compile time (split_layout):
//   - chunked (split_tail_xfade): one t-tile of TT columns a CTA, the
//     t-tiles along the grid's y, one rank a block, q built a 32-bin chunk
//     at a time beside the basis chunk, 99 KB of shared memory, two CTAs an
//     SM.  Past fpb 128 each t-tile builds its rows' q again (T_TILES
//     times).  What bounds it at 4,096 rows: about 2.7x its FMA time on the
//     card; an 8 x 8 tile costs as many shared-memory wavefronts as FMA
//     cycles, and a CTA's staging waits on L2.  Larger tiles measured
//     slower (8 x 16 a thread, as producer and consumer warps at one CTA an
//     SM, or at 128 threads and two CTAs an SM: PERF.md, the kernel table).
//     Where the tile fits a smaller block (T_FIT) its basis chunks, its
//     partials and each thread's register tile narrow with it (SplitTile),
//     and its shared memory shrinks to 36-66 KB.
//   - pipelined (split_tail_pipe), past one t-tile: q once per (tile,
//     block) for every kind of row at M = 128 (32 crossfading rows a tile),
//     one CTA an SM of 256 multiply threads and 64 fold threads, the
//     t-tiles one unbroken stream of basis chunks through a ring, each
//     t-tile folded while the next is multiplied (below).
// On an H100 (PERF.md, the pipelined layout) it took the least device
// time for rows 2-4 and 8 past one t-tile (against the layout before it,
// which walked the t-tiles one after another: 0.90-0.97x at fpb 1024 and
// 2048, rows 2 and 8 0.97-0.98x at fpb 256 and 512 and row 8 0.92x at 441,
// the live block's one row 0.82-0.95x; rows 3 and 4 at fpb 256 and 512
// within a run's spread) and for rows 5-7 from 16 t-tiles (fpb 2048:
// 0.83-0.97x the chunked one's); below 16 it lost for rows 5-7 where the
// grid is a few waves of its large tiles (fpb 256-1024, 1 x 2,048 rows: 64
// tiles on 30 or 15 clusters), and at one t-tile (f128t2048) for every
// row.  So the
// chunked layout stays for rows 5-7 below 16 t-tiles (filter rows
// pre-blended: a q chunk is four loads a product, and two CTAs an SM fill
// more of the card) and for every row at one t-tile.  Past 8 blocks (pad
// 4096) a cluster of 16 ranks is not portable: the launch allows it
// (cudaFuncAttributeNonPortableClusterSizeAllowed); an H100 holds 14 such
// clusters at two CTAs an SM (112 SMs), 7 at one (112 SMs); at pad 2048 30
// and 15 (120 SMs), at pad 1024 30 at one CTA an SM (120 SMs; the
// occupancy query, jt_split_occupancy).  Other layouts measured slower and
// went (PERF.md): 8 ranks of two blocks each at pad 4096; the t-tiles
// walked one after another with a cluster barrier pair between them (q
// once, M = 64, 128 threads, two CTAs an SM); the pipelined layout at M =
// 64 with 4 x 8 thread tiles (one CTA an SM), at M = 128 with 8 x 16 (128
// multiply threads), and at M = 64 with 8 x 8 (two CTAs an SM).  What
// bounds every layout: the FMA loop, an 8 x 8 thread tile loading as many
// shared-memory words a bin as the SM's schedulers issue FMAs for it, at
// about 2x the fp32 FMA time of the clusters' SMs; a larger tile leaves
// too few warps to hide the loads.
// The form exists up to 16 blocks, below fpb 128 with fpb % 4 == 0
// (HAS_SPLIT).
namespace cg = cooperative_groups;

constexpr int S_NBLK = (BINS - 1) / T_BLOCK;    // the blocked tail's 128-bin blocks
constexpr int S_MAX_BLOCKS = 16;                // ranks a cluster, at most (one block each)
// (rows of fpb floats that are not whole float4 columns, fpb % 4 != 0, are
// staged by 4-byte copies; the form takes them past fpb 128 only, where it
// was measured)
constexpr bool HAS_SPLIT = (BINS - 1) % T_BLOCK == 0 && S_NBLK >= 1 &&
                           S_NBLK <= S_MAX_BLOCKS && (FPB % 4 == 0 || T_TILES > 1);
constexpr int S_CHUNKS = T_BLOCK / T_KC;        // 32-bin q chunks of a block
static_assert(!HAS_SPLIT || S_NBLK * T_BLOCK == BINS - 1,
              "rank blocks cover bins 0 .. BINS-2, the last bin is folded last");

// A layout's shape: M operand rows (side, ear, row) of RPT a thread, TX
// threads along the T_COLS columns (CPT each: vectors of VW columns, G
// groups T_COLS / G apart), basis chunks of KC bins.
template <int SIDES, int M_, int RPT_, int CPT_, int KC_>
struct SplitShape {
  static constexpr int M = M_, RPT = RPT_, CPT = CPT_, KC = KC_;
  static constexpr int VW = CPT < 4 ? CPT : 4, G = CPT / VW;
  static constexpr int TX = T_COLS / CPT;
  static constexpr int THREADS = M / RPT * TX;
  static constexpr int R = M / (2 * SIDES);              // rows a tile
  static constexpr int QLD = M + 4;                      // padded bin stride of q
  static constexpr int BASIS = 2 * KC * T_COLS;          // one chunk of both basis planes
  static_assert(SIDES == 1 || R <= 32, "one warp lays out a crossfading tile's rows");
};
// The chunked layout's tile at 256 threads: at TT columns 16 threads of 8
// x 8 (columns 4tx .. 4tx+3 and 64+4tx ..); fitted to a smaller block, 4
// columns a thread (2 at fpb 4) and RPT = TX / 2 rows, so a thread holds
// T_COLS / 2 outputs.
struct SplitTile {
  static constexpr int CPT = T_COLS == TT ? 8 : T_COLS < 8 ? T_COLS / 2 : 4;
  static constexpr int RPT = T_COLS / CPT / 2;
};
template <int SIDES>  // q a chunk at a time
using ChunkedShape = SplitShape<SIDES, 128, SplitTile::RPT, SplitTile::CPT, T_KC>;

// A tile's filter rows arriving pre-blended (rows 5-7): old row r is
// g_rows[r], a segment's boundary row g_last[r / seg].
struct RowsPreBlended {
  const float* g_rows;
  const float* g_last;
  struct Entry {
    const float* g;
  };
  __device__ Entry old_row(int r) const { return {g_rows + (size_t)r * C4}; }
  __device__ Entry boundary(int r, int seg) const { return {g_last + (size_t)(r / seg) * C4}; }
  __device__ void filter(const Entry& e, int k, float (&g)[4]) const {
#pragma unroll
    for (int p = 0; p < 4; ++p) g[p] = e.g[p * BINS + k];
  }
};

// A tile's filter rows blended from a compact table (rows 2-4, 8): launch
// B's brackets, group offsets and rule for ids outside the group's table.
struct RowsBlended {
  const float* table;
  int u_rows;
  const int* ridx;
  const float* w;
  const int* bnd_idx;
  const float* bnd_w;
  int group_rows;
  struct Entry {
    int id[4];
    float w[4];
  };
  __device__ Entry make(const int* ids, const float* ws, int r) const {
    Entry e;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int id = ids[j];
      const bool in_table = id >= 0 && id < u_rows;
      e.id[j] = in_table ? (r / group_rows) * u_rows + id : 0;
      e.w[j] = in_table ? ws[j] : 0.f;
    }
    return e;
  }
  __device__ Entry old_row(int r) const { return make(ridx + r * 4, w + r * 4, r); }
  __device__ Entry boundary(int r, int seg) const {
    return make(bnd_idx + (r / seg) * 4, bnd_w + (r / seg) * 4, r);
  }
  __device__ void filter(const Entry& e, int k, float (&g)[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* trow = table + (size_t)e.id[j] * C4 + k;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float v = __fmul_rn(e.w[j], trow[p * BINS]);
        g[p] = j == 0 ? v : __fadd_rn(g[p], v);
      }
    }
  }
};

// A tile's staged filter rows: entry e serves row user[e][0]'s old side and
// row user[e][1]'s new side (-1: none), new_ent[i] is row i's new-side
// entry, n_ent the entries in use.
template <int SIDES, int R, class Rows>
struct SplitRows {
  typename Rows::Entry ent[SIDES == 2 ? 2 * R + 1 : R];
  int user[SIDES == 2 ? 2 * R + 1 : R][2];
  int new_ent[R];
  int n_ent;
};

// Lay out rows r0 .. r0+R-1's entries (every thread calls it; it ends on a
// barrier).
template <int THREADS, int SIDES, int R, class Rows>
__device__ __forceinline__ void split_stage_rows(SplitRows<SIDES, R, Rows>& t, const Rows& src,
                                                 int r0, int rows, int seg, int tid) {
  constexpr int ENT = SIDES == 2 ? 2 * R + 1 : R;
  for (int i = tid; i < ENT; i += THREADS) t.user[i][0] = t.user[i][1] = -1;
  __syncthreads();
  if constexpr (SIDES == 1) {
    // g_rows carries the new rows: row i's one side is old row i
    for (int i = tid; i < R; i += THREADS)
      if (r0 + i < rows) {
        t.ent[i] = src.old_row(r0 + i);
        t.user[i][0] = i;
        t.new_ent[i] = i;
      }
    if (tid == 0) t.n_ent = R;
  } else if (tid < 32) {  // warp 0, one lane per row
    const int i = tid, r = r0 + i;
    const bool live = i < R && r < rows;
    const bool inside = live && r % seg + 1 < seg;  // the new side is old row r+1
    const unsigned ends = __ballot_sync(~0u, live && !inside);
    if (live) {
      t.ent[i] = src.old_row(r);
      t.user[i][0] = i;
    }
    if (inside) {
      t.user[i + 1][1] = i;
      t.new_ent[i] = i + 1;
      if (i + 1 == R) t.ent[R] = src.old_row(r + 1);
    } else if (live) {
      const int e = R + 1 + __popc(ends & ((1u << i) - 1));
      t.ent[e] = src.boundary(r, seg);
      t.user[e][1] = i;
      t.new_ent[i] = e;
    }
    if (i == 0) t.n_ent = R + 1 + __popc(ends);
  }
  __syncthreads();
}

// One item of a q chunk: an entry's filter at one bin and the XD of the
// rows it serves, loaded; then its products stored.
struct QItem {
  int kk, u[2];
  float g[4], x[2][2];
};

// q of the 32 bins from k0 into qr, qi ([T_KC][QLD], m = (side*2 + ear)*R
// + row): a warp takes 4 entries x 8 bins (32-byte pieces of each filter
// plane); each entry's G multiplies the XD of the rows it serves.  Two
// items' loads are in flight before either's products are stored.
template <int THREADS, int SIDES, int R, int QLD, class Rows>
__device__ __forceinline__ void split_stage_q(const SplitRows<SIDES, R, Rows>& t,
                                              const Rows& src, const float* __restrict__ xdr,
                                              const float* __restrict__ xdi, int r0, int k0,
                                              float* qr, float* qi, int tid) {
  auto load = [&](int it, QItem& q) {
    const int lane = it % 32, wi = it / 32, e = (wi / 4) * 4 + lane / 8;
    q.kk = (wi % 4) * 8 + lane % 8;
    q.u[0] = q.u[1] = -1;
    if (e >= t.n_ent) return;
    q.u[0] = t.user[e][0];
    q.u[1] = t.user[e][1];
    if (q.u[0] < 0 && q.u[1] < 0) return;
    const int k = k0 + q.kk;
    src.filter(t.ent[e], k, q.g);
#pragma unroll
    for (int side = 0; side < SIDES; ++side)
      if (q.u[side] >= 0) {
        const size_t x = (size_t)(r0 + q.u[side]) * BINS + k;
        q.x[side][0] = xdr[x];
        q.x[side][1] = xdi[x];
      }
  };
  auto store = [&](const QItem& q) {
#pragma unroll
    for (int side = 0; side < SIDES; ++side)
      if (q.u[side] >= 0)
#pragma unroll
        for (int ear = 0; ear < 2; ++ear) {
          const int m = q.kk * QLD + (side * 2 + ear) * R + q.u[side];
          cmul_rn(q.x[side][0], q.x[side][1], q.g[2 * ear], q.g[2 * ear + 1], &qr[m], &qi[m]);
        }
  };
  const int items = (t.n_ent + 3) / 4 * 4 * T_KC;
  for (int it = tid; it < items; it += 2 * THREADS) {
    QItem q0, q1;
    load(it, q0);
    q1.u[0] = q1.u[1] = -1;
    if (it + THREADS < items) load(it + THREADS, q1);
    store(q0);
    store(q1);
  }
}

// Stage the basis chunk of bins k0 .. k0+KC-1, columns t0 .. t0+T_COLS-1
// (0 past FPB), into dst ([plane][KC][T_COLS]) as one commit group.
template <int THREADS, int KC>
__device__ __forceinline__ void split_stage_basis(float* dst, const float* __restrict__ icr,
                                                  const float* __restrict__ ici, int k0, int t0,
                                                  int tid) {
  constexpr int PLANE = KC * T_COLS;
  if constexpr (FPB % 4 == 0) {               // four columns all in or all out
    const size_t at = (size_t)k0 * FPB + t0;
    for (int i = tid; i < 2 * PLANE / 4; i += THREADS) {
      const int plane = i / (PLANE / 4), j = 4 * (i % (PLANE / 4));
      const int kk = j / T_COLS, tt = j % T_COLS;
      if (!B_MASK || t0 + tt < FPB)
        cp_async16(dst + plane * PLANE + j, (plane ? ici : icr) + at + (size_t)kk * FPB + tt);
      else
        *reinterpret_cast<float4*>(dst + plane * PLANE + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {                                    // rows of fpb floats: 4-byte copies
    for (int i = tid; i < 2 * PLANE; i += THREADS) {
      const int plane = i / PLANE, j = i % PLANE;
      const int kk = j / T_COLS, tt = j % T_COLS;
      if (t0 + tt < FPB)
        cp_async4(dst + plane * PLANE + j, (plane ? ici : icr) + (size_t)(k0 + kk) * FPB + t0 + tt);
      else
        dst[plane * PLANE + j] = 0.f;
    }
  }
  cp_async_commit();
}

// acc[i][j] += the chunk's KC bins of qr*br + qi*bi for operand row
// ty*RPT+i and output column g*(T_COLS/G) + VW*tx + v (j = g*VW + v): at TT
// columns 4tx+j (j < 4) or 64+4tx+j-4.  Bins ascending, each output's real
// then imaginary term: tail_chunk_fma's order per output.  (Threads as 4
// tx x 8 ty a warp, and the next bin's operands loaded into registers
// during this bin's products, measured slower on the card.)
template <class Shape, int UNROLL = 2>
__device__ __forceinline__ void split_chunk_fma(float (&acc)[Shape::RPT][Shape::CPT],
                                                const float* qr, const float* qi,
                                                const float* br, const float* bi, int tx,
                                                int ty) {
  constexpr int RPT = Shape::RPT, CPT = Shape::CPT, VW = Shape::VW, G = Shape::G;
  constexpr int QLD = Shape::QLD;
#pragma unroll (UNROLL)
  for (int kk = 0; kk < Shape::KC; ++kk) {
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const float* q = (plane ? qi : qr) + kk * QLD + ty * RPT;
      const float* v = (plane ? bi : br) + kk * T_COLS + tx * VW;
      float a[RPT], b[CPT];
      load_floats<RPT>(q, a);
#pragma unroll
      for (int g = 0; g < G; ++g) load_floats<VW>(v + g * (T_COLS / G), b + g * VW);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// A thread's block partial tile into part ([M][T_COLS], row ty*RPT+i, the
// columns split_chunk_fma gives it).
template <class Shape>
__device__ __forceinline__ void split_store_partial(float* part,
                                                    float (&acc)[Shape::RPT][Shape::CPT], int tx,
                                                    int ty) {
  constexpr int VW = Shape::VW, G = Shape::G;
#pragma unroll
  for (int i = 0; i < Shape::RPT; ++i)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* at = part + (ty * Shape::RPT + i) * T_COLS + g * (T_COLS / G) + tx * VW;
      const float* a = acc[i] + g * VW;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(at) = make_float4(a[0], a[1], a[2], a[3]);
      else if constexpr (VW == 2)
        *reinterpret_cast<float2*>(at) = make_float2(a[0], a[1]);
      else
        at[0] = a[0];
    }
}

// The last bin's q of the FOLD rows rank b folds (q4r, q4i: [(side*2 +
// ear)*FOLD + row], launch B's code).
template <int SIDES, int R, int FOLD, class Rows>
__device__ __forceinline__ void split_last_bin_q(const SplitRows<SIDES, R, Rows>& t,
                                                 const Rows& src, const float* __restrict__ xdr,
                                                 const float* __restrict__ xdi, int r0, int rows,
                                                 int b, float* q4r, float* q4i, int tid) {
  if (tid < SIDES * FOLD) {
    const int side = tid / FOLD, lr = tid % FOLD, row = b * FOLD + lr, r = r0 + row;
    if (r < rows) {
      float g[4];
      src.filter(t.ent[side ? t.new_ent[row] : row], BINS - 1, g);
      const size_t x = (size_t)r * BINS + BINS - 1;
#pragma unroll
      for (int ear = 0; ear < 2; ++ear) {
        const int m = (side * 2 + ear) * FOLD + lr;
        cmul_rn(xdr[x], xdi[x], g[2 * ear], g[2 * ear + 1], &q4r[m], &q4i[m]);
      }
    }
  }
}

// The last bin's basis row at columns t0 .. t0+T_COLS-1 (b4r, b4i: [T_COLS]).
template <int THREADS>
__device__ __forceinline__ void split_last_bin_basis(const float* __restrict__ icr,
                                                     const float* __restrict__ ici, int t0,
                                                     float* b4r, float* b4i, int tid) {
  for (int t = tid; t < T_COLS; t += THREADS) {
    const bool ok = !B_MASK || t0 + t < FPB;
    b4r[t] = ok ? icr[(size_t)(BINS - 1) * FPB + t0 + t] : 0.f;
    b4i[t] = ok ? ici[(size_t)(BINS - 1) * FPB + t0 + t] : 0.f;
  }
}

// After cluster.sync(): rank b folds its FOLD rows of the t-tile at t0 over
// every rank's partials (parts[q], q < RANKS: [M][T_COLS]) in block order,
// adds the last bin's chain, runs launch B's epilogue and writes.
template <int THREADS, int SIDES, int RANKS, int M, int FOLD>
__device__ __forceinline__ void split_fold(const float* const* parts, const float* q4r,
                                           const float* q4i, const float* b4r, const float* b4i,
                                           const float* __restrict__ xf, int r0, int rows, int b,
                                           int t0, float* __restrict__ out, int tid) {
  constexpr int R = M / (2 * SIDES);
  for (int i = tid; i < FOLD * 2 * T_W; i += THREADS) {
    const int lr = i / (2 * T_W), col = i % (2 * T_W), row = b * FOLD + lr, r = r0 + row;
    if (r >= rows) break;
    const int ear = col / T_W, tt = col % T_W, t = t0 + tt;
    if (T_MASK && t >= FPB) continue;
    float y[SIDES];
#pragma unroll
    for (int side = 0; side < SIDES; ++side) {
      const int m = (side * 2 + ear) * R + row;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < RANKS; ++q) v = __fadd_rn(v, parts[q][m * T_COLS + tt]);
      const int m4 = (side * 2 + ear) * FOLD + lr;
      y[side] = __fadd_rn(v, fmaf(q4i[m4], b4i[tt], fmaf(q4r[m4], b4r[tt], 0.f)));
    }
    float v = y[SIDES - 1];
    if (SIDES == 2) {                        // launch B's crossfade epilogue
      const float fn = (float)t / (float)(FPB - 1);
      const bool on = xf[r] > 0.f;
      const float a = on ? __fsub_rn(1.f, fn) : 0.f;
      const float bn = on ? fn : 1.f;
      v = __fadd_rn(__fmul_rn(y[0], a), __fmul_rn(y[SIDES - 1], bn));
    }
    out[(size_t)r * 2 * FPB + ear * FPB + t] = v;
  }
}

// The chunked layout: one t-tile a CTA (blockIdx.y), one block a rank (a
// cluster of RANKS along x, set at launch), q built a chunk at a time.
template <int SIDES, class Shape>
constexpr size_t chunked_smem() {
  return sizeof(float) * (2 * Shape::BASIS + 2 * T_KC * Shape::QLD);
}

template <int SIDES, int RANKS, class Rows>
__global__ void __launch_bounds__(256, T_FIT ? 3 : 2)
split_tail_xfade(const float* __restrict__ xdr, const float* __restrict__ xdi, int rows,
                 int seg, Rows src, const float* __restrict__ xf,
                 const float* __restrict__ icr, const float* __restrict__ ici,
                 float* __restrict__ out) {
  using Shape = ChunkedShape<SIDES>;
  constexpr int R = Shape::R, QLD = Shape::QLD, THREADS = Shape::THREADS, FOLD = R / RANKS;
  constexpr int BASIS = Shape::BASIS, RPT = Shape::RPT, CPT = Shape::CPT;
  static_assert(THREADS == 256 && FOLD * RANKS == R, "256 threads; ranks fold whole rows");
  static_assert(Shape::M * T_COLS <= 2 * BASIS, "the partials fit in the two basis buffers");
  extern __shared__ __align__(16) float smem[];
  float* basis = smem;                       // [buffer][plane][T_KC][T_COLS]
  float* qr = smem + 2 * BASIS;              // [T_KC][QLD], m = (side*2 + ear)*R + row
  float* qi = qr + T_KC * QLD;
  float* part = smem;                        // [M][T_COLS] after the main loop
  __shared__ SplitRows<SIDES, R, Rows> t;

  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();   // this CTA's tail block
  const int r0 = (int)(blockIdx.x / RANKS) * R;
  const int tid = threadIdx.x;
  const int kb = b * T_BLOCK;
  const int t0 = tile_t0();

  split_stage_basis<THREADS, T_KC>(basis, icr, ici, kb, t0, tid);
  for (int i = tid; i < 2 * T_KC * QLD; i += THREADS) qr[i] = 0.f;  // rows past the end
  split_stage_rows<THREADS>(t, src, r0, rows, seg, tid);

  const int tx = tid % Shape::TX, ty = tid / Shape::TX;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < S_CHUNKS; ++c) {
    // its buffer's readers passed the last barrier
    if (c + 1 < S_CHUNKS)
      split_stage_basis<THREADS, T_KC>(basis + ((c + 1) & 1) * BASIS, icr, ici,
                                       kb + (c + 1) * T_KC, t0, tid);
    split_stage_q<THREADS, SIDES, R, QLD>(t, src, xdr, xdi, r0, kb + c * T_KC, qr, qi, tid);
    if (c + 1 < S_CHUNKS)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const float* br = basis + (c & 1) * BASIS;
    split_chunk_fma<Shape>(acc, qr, qi, br, br + T_KC * T_COLS, tx, ty);
    __syncthreads();
  }

  // this rank's block partial into its own shared memory, and the last bin
  split_store_partial<Shape>(part, acc, tx, ty);
  float* q4r = qr;                           // [(side*2 + ear)*FOLD + row]
  float* q4i = q4r + SIDES * 2 * FOLD;
  float* b4r = q4i + SIDES * 2 * FOLD;       // [T_COLS]
  float* b4i = b4r + T_COLS;
  split_last_bin_q<SIDES, R, FOLD>(t, src, xdr, xdi, r0, rows, b, q4r, q4i, tid);
  split_last_bin_basis<THREADS>(icr, ici, t0, b4r, b4i, tid);
  cluster.sync();                            // every rank's partial stored

  const float* parts[RANKS];
#pragma unroll
  for (int q = 0; q < RANKS; ++q) parts[q] = cluster.map_shared_rank(part, q);
  split_fold<THREADS, SIDES, RANKS, Shape::M, FOLD>(parts, q4r, q4i, b4r, b4i, xf, r0, rows, b,
                                                    t0, out, tid);
  cluster.sync();                            // keep this partial until every rank read it
}

// The pipelined layout, past one t-tile (T_COLS == TT): one block a rank,
// q built once per (tile, block) for every kind of row, every t-tile
// walked inside, by the Shape's multiply threads (an 8 x 8 tile each)
// beside PIPE_FOLDERS fold threads:
//   - the first PIPE_STAGES - 1 basis chunks are in flight before q is
//     built (all threads build it, the items' loads two deep,
//     split_stage_q);
//   - the multiply threads walk the t-tiles as one stream of KC-bin basis
//     chunks (chunk n: t-tile n / CHUNKS, bins kb + (n % CHUNKS) * KC)
//     through a ring of PIPE_STAGES, one barrier of their own a chunk: the
//     next t-tile's first chunk lands while this one's last is multiplied,
//     and the ring never drains;
//   - t-tile i's partial goes to a buffer of its own, and the cluster
//     barrier is split, two phases a t-tile: phase 2i, every rank stored
//     partial i (the multiply threads arrive after storing it); phase
//     2i+1, every rank folded t-tile i (the fold threads arrive after
//     folding it over distributed shared memory, each rank its FOLD rows
//     in block order, split_fold's sums four columns at a time, while
//     t-tile i+1 is multiplied).  The multiply threads wait on phase 2i
//     (a barrier's latency: the ranks finish a t-tile together) and on
//     phase 2i+1 only before storing partial i+1, a t-tile later.
// The shape: M = 128 operand rows, 256 multiply threads of 8 x 8 outputs,
// basis chunks of 8 bins in a ring of 3, one CTA an SM: q 2 x 128 x 132
// floats (135,168 bytes), the ring 24,576, the partial 65,536, the last
// bin's q, with the staged rows 223 KB of the 227 a CTA may have.  Warp w
// multiplies 16 consecutive operand rows of one (side, ear) group, from
// (w % 4) * M/4 + (w / 4) * 16, so that the warps of a tile's first rows
// run on the SM's four schedulers (warp w on scheduler w % 4), and a warp
// whose rows all lie past the last row skips the loop: a tile of one row
// multiplies its four live operand rows on four warps, one a scheduler.
constexpr int PIPE_STAGES = 3;                   // basis chunks in the ring
constexpr int PIPE_FOLDERS = 64;                 // fold threads (two warps)
template <int SIDES>
using PipeShape = SplitShape<SIDES, 128, 8, 8, T_KC / 4>;

template <int SIDES, int RANKS, class Shape>
constexpr size_t pipe_smem() {
  constexpr int FOLD = Shape::R / RANKS;
  return sizeof(float) * (2 * T_BLOCK * Shape::QLD + PIPE_STAGES * Shape::BASIS +
                          Shape::M * T_COLS + 2 * SIDES * 2 * FOLD);
}

// The cluster barrier in halves: arrive publishes this thread's shared
// memory writes to the cluster, wait returns once every thread of every
// rank arrived and makes theirs visible.  Each thread alternates them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A barrier of the first N threads alone (named barrier 1).
template <int N>
__device__ __forceinline__ void first_threads_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// The fold threads' share of t-tile t0's fold (split_fold's sums and
// epilogue, four consecutive columns a step): rank b's FOLD rows over every
// rank's partial (parts[q]: [M][TT]) in block order, the last bin's chain
// (its basis read from icr, ici), launch B's epilogue, the output written.
template <int SIDES, int RANKS, int M, int FOLD>
__device__ __forceinline__ void pipe_fold(const float* const* parts, const float* q4r,
                                          const float* q4i, const float* __restrict__ icr,
                                          const float* __restrict__ ici,
                                          const float* __restrict__ xf, int r0, int rows, int b,
                                          int t0, float* __restrict__ out, int ft) {
  constexpr int R = M / (2 * SIDES), V4 = TT / 4;
  const float* last_r = icr + (size_t)(BINS - 1) * FPB;
  const float* last_i = ici + (size_t)(BINS - 1) * FPB;
  for (int i = ft; i < FOLD * 2 * V4; i += PIPE_FOLDERS) {
    const int lr = i / (2 * V4), ear = i / V4 % 2, tt = 4 * (i % V4);
    const int row = b * FOLD + lr, r = r0 + row;
    if (r >= rows) break;
    if (T_MASK && t0 + tt >= FPB) continue;
    float b4r[4], b4i[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = !T_MASK || t0 + tt + c < FPB;
      b4r[c] = ok ? last_r[t0 + tt + c] : 0.f;
      b4i[c] = ok ? last_i[t0 + tt + c] : 0.f;
    }
    float y[SIDES][4];
#pragma unroll
    for (int side = 0; side < SIDES; ++side) {
      const int m = (side * 2 + ear) * R + row;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < RANKS; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(parts[q] + m * TT + tt);
        v[0] = __fadd_rn(v[0], p.x);
        v[1] = __fadd_rn(v[1], p.y);
        v[2] = __fadd_rn(v[2], p.z);
        v[3] = __fadd_rn(v[3], p.w);
      }
      const int m4 = (side * 2 + ear) * FOLD + lr;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y[side][c] = __fadd_rn(v[c], fmaf(q4i[m4], b4i[c], fmaf(q4r[m4], b4r[c], 0.f)));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = t0 + tt + c;
      if (T_MASK && t >= FPB) break;
      float v = y[SIDES - 1][c];
      if (SIDES == 2) {                      // launch B's crossfade epilogue
        const float fn = (float)t / (float)(FPB - 1);
        const bool on = xf[r] > 0.f;
        const float a = on ? __fsub_rn(1.f, fn) : 0.f;
        const float bn = on ? fn : 1.f;
        v = __fadd_rn(__fmul_rn(y[0][c], a), __fmul_rn(y[SIDES - 1][c], bn));
      }
      out[(size_t)r * 2 * FPB + ear * FPB + t] = v;
    }
  }
}

template <int SIDES, int RANKS, class Shape, class Rows>
__global__ void __launch_bounds__(Shape::THREADS + PIPE_FOLDERS, 1)
split_tail_pipe(const float* __restrict__ xdr, const float* __restrict__ xdi, int rows,
                int seg, Rows src, const float* __restrict__ xf,
                const float* __restrict__ icr, const float* __restrict__ ici,
                float* __restrict__ out) {
  constexpr int M = Shape::M, R = Shape::R, RPT = Shape::RPT, CPT = Shape::CPT;
  constexpr int QLD = Shape::QLD, KC = Shape::KC, BASIS = Shape::BASIS;
  constexpr int THREADS = Shape::THREADS, ALL = THREADS + PIPE_FOLDERS, FOLD = R / RANKS;
  constexpr int CHUNKS = T_BLOCK / KC, N = T_TILES * CHUNKS, PART = M * TT;
  static_assert(FOLD * RANKS == R, "ranks fold whole rows");
  static_assert(T_COLS == TT && Shape::TX * CPT == TT, "t-tiles of TT columns");
  static_assert(THREADS % 32 == 0 && N >= PIPE_STAGES - 1, "whole warps a role; a full ring");
  extern __shared__ __align__(16) float smem[];
  float* qr = smem;                          // [T_BLOCK][QLD], m = (side*2 + ear)*R + row
  float* qi = qr + T_BLOCK * QLD;
  float* ring = qi + T_BLOCK * QLD;          // [stage][plane][KC][TT]
  float* part = ring + PIPE_STAGES * BASIS;  // [M][TT]
  float* q4r = part + PART;                  // [(side*2 + ear)*FOLD + row]
  float* q4i = q4r + SIDES * 2 * FOLD;
  __shared__ SplitRows<SIDES, R, Rows> t;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // this CTA's tail block
  const int r0 = (int)(blockIdx.x / RANKS) * R;
  const int tid = threadIdx.x;
  const int kb = rank * T_BLOCK;
  auto stage = [&](int n) {                  // chunk n into its ring slot, one commit group
    split_stage_basis<THREADS, KC>(ring + n % PIPE_STAGES * BASIS, icr, ici,
                                   kb + n % CHUNKS * KC, n / CHUNKS * TT, tid);
  };

  if (tid < THREADS)
    for (int n = 0; n < PIPE_STAGES - 1; ++n) stage(n);
  for (int i = tid; i < 2 * T_BLOCK * QLD; i += ALL) qr[i] = 0.f;  // rows past the end
  split_stage_rows<ALL>(t, src, r0, rows, seg, tid);
  for (int c = 0; c < S_CHUNKS; ++c)
    split_stage_q<ALL, SIDES, R, QLD>(t, src, xdr, xdi, r0, kb + c * T_KC, qr + c * T_KC * QLD,
                                      qi + c * T_KC * QLD, tid);
  split_last_bin_q<SIDES, R, FOLD>(t, src, xdr, xdi, r0, rows, rank, q4r, q4i, tid);
  __syncthreads();

  if (tid < THREADS) {
    constexpr int WARP_ROWS = 32 / Shape::TX * RPT;   // a warp's operand rows
    static_assert(THREADS == 256 && WARP_ROWS == 16 && M / 4 % WARP_ROWS == 0 &&
                  R % (M / 4) == 0, "eight warps, each within one (side, ear) group");
    const int w = tid / 32, first = w % 4 * (M / 4) + w / 4 * WARP_ROWS;
    const int tx = tid % Shape::TX, ty = (first + tid % 32 / Shape::TX * RPT) / RPT;
    const bool live = r0 + first % R < rows;  // the warp's first row, inside the tile's group
    for (int tile = 0, n = 0; tile < T_TILES; ++tile) {
      float acc[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < CHUNKS; ++c, ++n) {
        cp_async_wait<PIPE_STAGES - 2>();    // chunk n is in (this thread's copies)
        first_threads_sync<THREADS>();       // ... everyone's; slot (n-1) % PIPE_STAGES is free
        if (n + PIPE_STAGES - 1 < N)
          stage(n + PIPE_STAGES - 1);
        else
          cp_async_commit();                 // an empty group keeps the count
        const float* br = ring + n % PIPE_STAGES * BASIS;
        if (live)
          split_chunk_fma<Shape, KC>(acc, qr + c * KC * QLD, qi + c * KC * QLD, br,
                                     br + KC * TT, tx, ty);
      }
      if (tile > 0) cluster_wait();          // phase 2 tile - 1: every rank folded tile - 1
      split_store_partial<Shape>(part, acc, tx, ty);
      cluster_arrive();                      // phase 2 tile
      cluster_wait();
      cluster_arrive();                      // phase 2 tile + 1: ends once every rank folded
    }
  } else {
    const float* parts[RANKS];
#pragma unroll
    for (int q = 0; q < RANKS; ++q) parts[q] = cluster.map_shared_rank(part, q);
    for (int tile = 0; tile < T_TILES; ++tile) {
      cluster_arrive();                      // phase 2 tile
      cluster_wait();                        // every rank's partial of this t-tile stored
      pipe_fold<SIDES, RANKS, M, FOLD>(parts, q4r, q4i, icr, ici, xf, r0, rows, rank, tile * TT,
                                       out, tid - THREADS);
      cluster_arrive();                      // phase 2 tile + 1
      if (tile + 1 < T_TILES) cluster_wait();
    }
  }
  cluster_wait();                            // keep the partials until every rank read them
}

// Launch ``kernel`` over ``grid`` in clusters of ``ranks`` CTAs along x,
// its shared memory raised (and a cluster past 8 allowed) first.
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, size_t smem, int ranks,
                           cudaStream_t s, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (ranks > 8) {                           // past the portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The split form's layouts (jt_geometry reports the one each kind of row
// takes).
enum SplitLayout { LAYOUT_NONE = 0, LAYOUT_CHUNKED = 1, LAYOUT_PIPE = 2 };

// The layout of launch B's split form for rows of kind Rows (blended:
// RowsBlended; kernels/fused_step.split_default says the same), where it
// took the least device time alone on an H100 (PERF.md): the pipelined one
// past one t-tile for blended rows and from PIPE_PRE_BLENDED_TILES t-tiles
// for pre-blended rows, else the chunked one.
constexpr int PIPE_PRE_BLENDED_TILES = 16;       // fpb 2048 and up
template <class Rows>
constexpr int split_layout() {
  constexpr bool blended = std::is_same<Rows, RowsBlended>::value;
  if (!HAS_SPLIT) return LAYOUT_NONE;
  if (T_TILES > 1 && (blended || T_TILES >= PIPE_PRE_BLENDED_TILES)) return LAYOUT_PIPE;
  return LAYOUT_CHUNKED;
}

// fn(kernel, rows a tile, CTAs along y, threads, shared memory) for the
// split form's kernel over SIDES sides of rows of kind Rows, in its
// layout; cudaErrorInvalidValue where the geometry has no split form.
template <int SIDES, class Rows, class Fn>
cudaError_t with_split_kernel(Fn fn) {
  constexpr int layout = split_layout<Rows>();
  if constexpr (layout == LAYOUT_PIPE) {
    using Shape = PipeShape<SIDES>;
    return fn(split_tail_pipe<SIDES, S_NBLK, Shape, Rows>, Shape::R, 1,
              Shape::THREADS + PIPE_FOLDERS, pipe_smem<SIDES, S_NBLK, Shape>());
  } else if constexpr (layout == LAYOUT_CHUNKED) {
    using Shape = ChunkedShape<SIDES>;
    return fn(split_tail_xfade<SIDES, S_NBLK, Rows>, Shape::R, T_TILES, Shape::THREADS,
              chunked_smem<SIDES, Shape>());
  } else {
    return cudaErrorInvalidValue;
  }
}

// Launch B's split form over ``rows`` rows in segments of ``seg``, in the
// layout split_layout names.  A refused launch (shared memory, registers,
// cluster occupancy) returns its error, and a geometry without the form
// cudaErrorInvalidValue.
template <int SIDES, class Rows>
cudaError_t launch_split_tail(cudaStream_t s, const float* xdr, const float* xdi, int rows,
                              int seg, const Rows& src, const float* xf, const float* icr,
                              const float* ici, float* out) {
  return with_split_kernel<SIDES, Rows>([&](auto kernel, int tile_rows, int y, int threads,
                                            size_t smem) {
    const int tiles = (rows + tile_rows - 1) / tile_rows;
    return launch_cluster(kernel, dim3(tiles * S_NBLK, y), threads, smem, S_NBLK, s, xdr, xdi,
                          rows, seg, src, xf, icr, ici, out);
  });
}

// How many of the split form's clusters (SIDES sides, rows of kind Rows)
// the card holds at once: out = {clusters, CTAs a cluster, CTAs an SM,
// threads, shared memory}.
template <int SIDES, class Rows>
cudaError_t split_occupancy(int* out) {
  return with_split_kernel<SIDES, Rows>([&](auto kernel, int, int, int threads, size_t smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && S_NBLK > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S_NBLK, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S_NBLK;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&out[0], kernel, &cfg);
    if (err != cudaSuccess) return err;
    out[1] = S_NBLK;
    out[3] = threads;
    out[4] = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, smem);
  });
}

// The forms of launch B an entry takes: one CTA per 32-row tile, the split
// form above, or row 1's staged form (fused_step_onehot.cu: one chain over
// K, the blend staged and overlapped with the chains).
enum TailForm { FORM_LAUNCH_B = 0, FORM_SPLIT = 1, FORM_STAGED = 2 };

}  // namespace

// The geometry this library was built for and the forms it has, for the
// wrappers to check their mirror (kernels/fused_step.geometry_forms):
// out[0..12] = fpb, pad, bins, q (0: a history of partial blocks), FEW_NB,
// product form, split form, row 1's staged form, row 8's cluster form,
// launch A's tile form, the columns of launch B's and the chunked layout's
// tile (T_COLS), the split form's layout (SplitLayout) for blended rows
// (rows 2-4, 8) and for pre-blended rows (rows 5-7).
extern "C" void jt_geometry(int* out) {
  out[0] = FPB;
  out[1] = PAD;
  out[2] = BINS;
  out[3] = ALIGNED ? Q : 0;
  out[4] = FEW_NB;
  out[5] = HAS_PRODUCT;
  out[6] = HAS_SPLIT;
  out[7] = JT_TUNED_128;
  out[8] = JT_TUNED_128;
  out[9] = HAS_TILE;
  out[10] = T_COLS;
  out[11] = split_layout<RowsBlended>();
  out[12] = split_layout<RowsPreBlended>();
}

// The split form's occupancy on ``device`` for blended rows (rows 2-4, 8)
// or pre-blended ones, at ``sides`` sides (split_occupancy's out[0..4]);
// the first CUDA error, cudaErrorInvalidValue without the form.
extern "C" int jt_split_occupancy(int device, int blended, int sides, int* out) {
  return on_device(device, [&]() {
    if (blended) return sides == 2 ? split_occupancy<2, RowsBlended>(out) : cudaErrorInvalidValue;
    return sides == 2 ? split_occupancy<2, RowsPreBlended>(out)
                      : split_occupancy<1, RowsPreBlended>(out);
  });
}
