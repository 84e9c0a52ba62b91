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
//     few-block form at nb <= FEW_NB blocks a source; the tile or ring form
//     at other geometries): XD to a scratch buffer.
//   B (blend_tail_xfade): one CTA per 32 rows.  The four (side, ear)
//     products form a 128-row operand against the (513 x 128) tail basis,
//     tiled along K = 513 in 32-bin chunks through shared memory, with an
//     8 x 8 register tile per thread; the crossfade is the epilogue.  Rows
//     3 and 4 sum the tail by 128-bin blocks (the blocked tail,
//     fused_forward.cuh); row 1 keeps one chain over K, as it was first
//     measured (the blocked form's extra registers would halve its
//     occupancy at 512 CTAs), in this form or, from STAGED_FROM rows
//     (kernels/fused_step.py), in the staged form (blend_tail_staged,
//     below): the same bits.
//
// Numerics: the blend, complex multiplies and crossfade round each product
// on its own (__fmul_rn/__fadd_rn); only the tail dot products use fmaf.
//
// Rows 2-4 and 8 also take launch B's split form (fused_forward.cuh: a
// cluster of CTAs per tile, one per 128-bin block, each table row blended
// once a tile), with the same bits; row 1 cannot (one chain), and
// takes the staged form instead.
//
// Row 8 at few rows (the live block step: one row) has its own launch, the
// cluster form (spatializer_cluster, below): launch B there builds a
// 128-row operand of which 4 rows are real and walks all of K on one SM.
//
// Geometry (fused_forward.cuh): launch B runs at every geometry and its
// split form where HAS_SPLIT, a CTA per 32 rows and TT = 128 output columns
// (T_TILES along the grid's y at fpb above 128).  Below 128, where fpb
// divides 128, the tile is fpb columns wide (T_COLS), so a CTA spends no
// FMA, shared memory or basis copy past fpb; a CTA takes 16 rows (B_ROWS:
// twice the CTAs) and each thread a narrower tile whose basis arrives in
// float4s (TailTile: 4 x 8 at fpb 64, 1 x 8 at 16, 1 x 2 at 4).  What is
// left is the q build (bracket rows through L2) and an FMA loop read from
// shared memory.  At fpb 100 the 128-column tile stays, its columns past
// fpb zeros that store nothing.  Row 1's staged
// form and row 8's cluster form are laid out for fpb 128 / pad 1024 and exist
// only there (JT_TUNED_128); elsewhere row 1 takes launch B and row 8 the
// split form or launch B.

#include "fused_forward.cuh"

namespace {

constexpr int B_R = B_ROWS;             // output rows per CTA (16 where the tile fits)
constexpr int B_M = 4 * B_R;            // (side, ear, row) operand rows
constexpr int B_THREADS = 2 * B_M;      // 16 x 16 threads, 8 x 8 outputs each (TailTile)
constexpr size_t B_SMEM = sizeof(float) * (2 * B_M * T_QS + 2 * T_KC * T_COLS);
static_assert(B_M * T_COLS <= 2 * B_M * T_QS + 2 * T_KC * T_COLS,
              "epilogue tile must fit in the main-loop shared memory");
static_assert(B_THREADS == 2 * B_R * 4, "one thread per (side, row, bracket)");

std::atomic<unsigned long long> launch_b_smem_set[2];   // by BLOCKED

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
  float* br = qi + B_M * T_QS;      // [T_KC][T_COLS]
  float* bi = br + T_KC * T_COLS;
  float* y = smem;                  // epilogue [B_M][T_COLS], after the main loop
  __shared__ int sid[2][B_R][4];    // [side][row][bracket]: side 0 old, 1 new
  __shared__ float swt[2][B_R][4];

  const int r0 = blockIdx.x * B_R;
  const int t0 = tile_t0();
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

  constexpr int RI = TailTile::RI, CJ = TailTile::CJ;
  const int tx = tid % TailTile::TX, ty = tid / TailTile::TX;
  float acc[RI][CJ], part[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < BINS; k0 += T_KC) {
    if constexpr (T_FIT) start_fit_basis(br, bi, icr, ici, k0, tid, B_THREADS);
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
    if constexpr (T_FIT)
      cp_async_wait<0>();
    else
      load_tail_basis(br, bi, icr, ici, k0, t0, tid, B_THREADS);
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
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) y[(ty * RI + i) * T_COLS + TailTile::col(tx, j)] = acc[i][j];
  __syncthreads();

  // crossfade epilogue: out[r] = [L fpb | R fpb], this tile's columns
  for (int i = tid; i < B_R * 2 * T_W; i += B_THREADS) {
    const int row = i / (2 * T_W), col = i % (2 * T_W), r = r0 + row;
    if (r >= rows) break;
    const int ear = col / T_W, tt = col % T_W, t = t0 + tt;
    if (T_MASK && t >= FPB) continue;
    const float y_old = y[(ear * B_R + row) * T_COLS + tt];
    const float y_new = y[((2 + ear) * B_R + row) * T_COLS + tt];
    const float fn = (float)t / (float)(FPB - 1);
    const bool on = xf[r] > 0.f;
    const float a = on ? __fsub_rn(1.f, fn) : 0.f;
    const float b = on ? fn : 1.f;
    out[(size_t)r * 2 * FPB + ear * FPB + t] = __fadd_rn(__fmul_rn(y_old, a), __fmul_rn(y_new, b));
  }
}

// Launch B, one CTA per 32-row tile and t-tile.
template <bool BLOCKED>
cudaError_t launch_blend_tail(cudaStream_t s, const float* xdr, const float* xdi, int rows,
                              const float* table, int u_rows, const int* ridx, const float* w,
                              const int* bnd_idx, const float* bnd_w, int seg, int group_rows,
                              const float* xf, const float* icr, const float* ici, float* out) {
  const cudaError_t err =
      allow_smem_once(blend_tail_xfade<BLOCKED>, B_SMEM, launch_b_smem_set[BLOCKED ? 1 : 0]);
  if (err != cudaSuccess) return err;
  blend_tail_xfade<BLOCKED><<<dim3((rows + B_R - 1) / B_R, T_TILES), B_THREADS, B_SMEM, s>>>(
      xdr, xdi, rows, table, u_rows, ridx, w, bnd_idx, bnd_w, seg, group_rows, xf, icr, ici, out);
  return cudaGetLastError();
}

#if JT_TUNED_128
// ---- row 1's launch B, the staged form ---------------------------------------
//
// Row 1 sums each output's tail as one fmaf chain over K, so it cannot take
// the split form.  Where launch B (above) spends its time at 256 x 64
// (PERF.md, row 1): its FMA loop alone 0.47 of its 0.61 ms, the q-build
// alone 0.18, the epilogue 0.02.  The q-build gathers, for every (row,
// side, bin), the row's four bracket rows through L2 (side 1 of row r is
// side 0 of row r+1 inside a segment), with no FMA running meanwhile; the
// 8 x 8 FMA loop reads a shared-memory value for every four FMAs.  Here a
// CTA of 256 threads owns a 32-row tile in two warpgroups that never meet
// again after the set-up, two CTAs an SM (86 KB of shared memory each):
//   - the tile's filter rows are its entries, each blended once: old rows
//     r0 .. r0+31, then row r0+32 or the segment ends' boundary rows (the
//     split form's staging); their bracket ids are deduplicated through a
//     hash table in shared memory into D distinct table rows (the bench
//     step: 14 on average, at most 38);
//   - the producer warpgroup (80 registers a thread after setmaxnreg)
//     stages, per 8-bin chunk, the D rows' four plane windows (16-byte
//     cp.async; P_DCAP rows at most, else the blend reads the table through
//     L2), the tile's XD (4-byte cp.async) and the chunk of the tail basis,
//     and blends every entry at every bin of the chunk into q in launch B's
//     exact op order (__fmul_rn, __fadd_rn in bracket order, cmul_rn per
//     user row and ear), a quarter-warp an entry and a lane a bin, up to
//     three chunks ahead in a ring of four;
//   - the consumer warpgroup (176 registers) runs the chains, each thread a
//     16 x 8 register tile whose operands are six 16-byte shared-memory
//     loads a bin and plane, each output fmaf(qr, br) then fmaf(qi, bi) over
//     k = 0 .. 512 ascending from 0 (bin 512 a chunk of its own, not bins of
//     zeros), then launch B's crossfade epilogue; named barriers pass the
//     ring's stages between the roles.
// So every output is launch B's bit for bit: the same q values in the same
// chain.  What bounds it: the shared-memory pipe, which both roles share.
// Alone, with q and the basis fixed, a 16 x 8 chain loop ran at 74% of the
// FMA rate (8 x 16 with scalar q loads 62-65%, no loads at all 86%); in
// the form the consumers alone take 0.40 ms at 256 x 64 and the blend and
// copies add about 0.19 whatever the ring's depth (PERF.md, row 1).
constexpr int P_R = 32;                         // output rows a tile
constexpr int P_M = 4 * P_R;                    // (side, ear, row) operand rows
constexpr int P_KC = 8;                         // bins a chunk
constexpr int P_STAGES = 4;                     // q and basis chunks in the ring
constexpr int P_CONS = 128;                     // consumers: 8 x 16, 16 x 8 outputs each
constexpr int P_PROD = 128;                     // producers: a quarter-warp an entry, a lane a bin
constexpr int P_PROD_REGS = 80;                 // registers a thread after setmaxnreg
constexpr int P_CONS_REGS = 176;
constexpr int P_THREADS = P_CONS + P_PROD;
constexpr int P_ENT = 2 * P_R + 1;              // filter rows a tile blends, at most
constexpr int P_DCAP = 40;                      // distinct table rows staged, at most
constexpr int P_WIN = 12;                       // a staged plane window: bins k0-p .. k0-p+11
constexpr int P_CHUNKS = (BINS - 1) / P_KC + 1; // 64 of 8 bins, then bin 512 alone
constexpr int P_QS = P_KC + 1;                  // padded row stride of an XD chunk
constexpr int P_QLD = P_M + 4;                  // padded bin stride of a q chunk
constexpr int P_RD = 4 * P_WIN + 4;             // a distinct row's windows, padded: 20 banks
                                                // apart from the next row's
constexpr int P_HASH = 256;
constexpr int P_QBUF = 2 * P_KC * P_QLD;        // [plane][kk][m]
constexpr int P_BBUF = 2 * P_KC * FPB;          // [plane][kk][t]
constexpr int P_RBUF = P_DCAP * P_RD;           // [distinct row][plane][window]
constexpr int P_XBUF = 2 * P_R * P_QS;          // [plane][row][kk]
constexpr size_t P_SMEM =
    sizeof(float) * (P_STAGES * (P_QBUF + P_BBUF) + 2 * (P_RBUF + P_XBUF));
constexpr int P_QUARTERS = P_PROD / P_KC;       // entries blended at once
// named barriers: 0 is __syncthreads; ring stage s is full at 1 + s and
// free at 1 + P_STAGES + s; the producers' own, then the consumers'
constexpr int BAR_FULL = 1, BAR_FREE = 1 + P_STAGES, BAR_PROD = 1 + 2 * P_STAGES,
              BAR_CONS = 2 + 2 * P_STAGES;
static_assert(BAR_CONS < 16, "16 named barriers");
static_assert(P_CONS == 128 && P_PROD == 128, "one warpgroup a role (setmaxnreg)");
static_assert(P_PROD * P_PROD_REGS + P_CONS * P_CONS_REGS <= 65536 / 2, "two CTAs an SM");
static_assert(P_M * FPB <= P_STAGES * (P_QBUF + P_BBUF), "the epilogue tile fits the ring");
static_assert(P_QBUF % 4 == 0 && P_BBUF % 4 == 0 && P_RBUF % 4 == 0, "16-byte cp.async targets");
static_assert(P_ENT * 4 <= 2 * P_THREADS, "two brackets of an entry a thread at most");
static_assert(P_CONS * 16 * 8 == P_M * FPB, "consumer tiles cover the operand");
static_assert(P_WIN % 4 == 0 && P_WIN >= P_KC + 3, "a plane window covers its bins");
static_assert(P_RD % 4 == 0 && P_QLD % 4 == 0, "16-byte windows and q rows");
static_assert(P_ENT * 4 <= 2 * P_HASH, "the hash table stays half empty at most");

std::atomic<unsigned long long> staged_smem_set{0};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// acc[i][j] += the chunk's first nk bins of qr*br + qi*bi for operand row
// ty*16+i and output column 4tx + j (j < 4) or 64 + 4tx + j-4: bins
// ascending, each output's real then imaginary term, tail_chunk_fma's
// order per output.  q is [kk][P_QLD] and the basis [kk][FPB]: six float4
// loads a bin and plane.
__device__ __forceinline__ void staged_chunk_fma(float (&acc)[16][8], const float* qr,
                                                 const float* qi, const float* br,
                                                 const float* bi, int tx, int ty, int nk) {
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const float* q = (plane ? qi : qr) + kk * P_QLD + ty * 16;
      const float* v = (plane ? bi : br) + kk * FPB + tx * 4;
      float a[16], b[8];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(q + 4 * g);
        a[4 * g] = f.x;
        a[4 * g + 1] = f.y;
        a[4 * g + 2] = f.z;
        a[4 * g + 3] = f.w;
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 f = *reinterpret_cast<const float4*>(v + 64 * g);
        b[4 * g] = f.x;
        b[4 * g + 1] = f.y;
        b[4 * g + 2] = f.z;
        b[4 * g + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(P_THREADS, 2)
blend_tail_staged(const float* __restrict__ xdr, const float* __restrict__ xdi, int rows,
                  int seg, RowsBlended src, const float* __restrict__ xf,
                  const float* __restrict__ icr, const float* __restrict__ ici,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* qbuf = smem;                           // [stage][P_QBUF]
  float* bbuf = qbuf + P_STAGES * P_QBUF;       // [stage][P_BBUF]
  float* rbuf = bbuf + P_STAGES * P_BBUF;       // [buffer][P_RBUF]
  float* xbuf = rbuf + 2 * P_RBUF;              // [buffer][P_XBUF]
  float* y = smem;                              // [P_M][FPB] after the main loop
  __shared__ RowsBlended::Entry ent[P_ENT];     // the tile's filter rows
  __shared__ int ent_d[P_ENT][4];               // each bracket's distinct row
  __shared__ int user[P_ENT][2];                // the row whose side 0 / 1 it is, or -1
  __shared__ int hkey[P_HASH], hrow[P_HASH];    // table id -> distinct row
  __shared__ int distinct[P_ENT * 4];           // distinct row -> table id
  __shared__ int n_ent, n_distinct;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * P_R;

  for (int i = tid; i < P_ENT; i += P_THREADS) user[i][0] = user[i][1] = -1;
  for (int i = tid; i < P_HASH; i += P_THREADS) hkey[i] = -1;
  for (int i = tid; i < P_STAGES * P_QBUF; i += P_THREADS) qbuf[i] = 0.f;   // rows past the end
  if (tid == 0) n_distinct = 0;
  __syncthreads();
  if (tid < P_R) {  // warp 0, one lane per row: the split form's entries
    const int i = tid, r = r0 + i;
    const bool live = r < rows;
    const bool inside = live && r % seg + 1 < seg;   // the new side is old row r+1
    const unsigned ends = __ballot_sync(~0u, live && !inside);
    if (live) {
      ent[i] = src.old_row(r);
      user[i][0] = i;
    }
    if (inside) {
      user[i + 1][1] = i;
      if (i + 1 == P_R) ent[P_R] = src.old_row(r + 1);
    } else if (live) {
      const int e = P_R + 1 + __popc(ends & ((1u << i) - 1));
      ent[e] = src.boundary(r, seg);
      user[e][1] = i;
    }
    if (i == 0) n_ent = P_R + 1 + __popc(ends);
  }
  __syncthreads();
  const int ne = n_ent;
  // each thread inserts the ids of (entry, bracket) tid and tid + P_THREADS
  int hs[2] = {0, 0};
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int e = (tid + t * P_THREADS) / 4, j = (tid + t * P_THREADS) % 4;
    if (e >= ne || (user[e][0] < 0 && user[e][1] < 0)) continue;
    const int id = ent[e].id[j];
    int h = (int)(((unsigned)id * 2654435761u) >> 24) & (P_HASH - 1);
    for (;;) {
      const int prev = atomicCAS(&hkey[h], -1, id);
      if (prev == -1) {                         // first of its id
        const int d = atomicAdd(&n_distinct, 1);
        hrow[h] = d;
        distinct[d] = id;
        break;
      }
      if (prev == id) break;
      h = (h + 1) & (P_HASH - 1);
    }
    hs[t] = h;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int e = (tid + t * P_THREADS) / 4, j = (tid + t * P_THREADS) % 4;
    if (e < ne) ent_d[e][j] = (user[e][0] < 0 && user[e][1] < 0) ? 0 : hrow[hs[t]];
  }
  __syncthreads();
  const int nd = n_distinct;
  const bool staged = nd <= P_DCAP;

  // Two warpgroups in two roles that never meet again: the producers give
  // up registers the consumers' 16 x 8 tiles take.
  if (tid >= P_CONS) {
    // ---- producers: a quarter-warp an entry or XD row, a lane a bin ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P_PROD_REGS));
    const int p = tid - P_CONS, lane = p % 32, quarter = p / P_KC, kk = p % P_KC;
    auto issue_rows = [&](int c) {              // chunk c's table windows and XD
      const int k0 = c * P_KC, nk = min(P_KC, BINS - k0);
      const int n4 = nk == P_KC ? P_WIN / 4 : 1;   // bin 512: bins 512-p .. 515-p
      float* rb = rbuf + (c & 1) * P_RBUF;
      if (staged)
        for (int i = p; i < nd * 4 * n4; i += P_PROD) {
          const int j = i / n4, q4 = i - j * n4, d = j / 4, pl = j % 4;
          // plane pl starts at pl*BINS = pl*(BINS-1) + pl: its window starts
          // pl floats early, on a 16-byte boundary
          cp_async16(rb + d * P_RD + pl * P_WIN + 4 * q4,
                     src.table + (size_t)distinct[d] * C4 + pl * (BINS - 1) + k0 + 4 * q4);
        }
      float* xb = xbuf + (c & 1) * P_XBUF;
      if (kk < nk)
        for (int j = quarter; j < 2 * P_R; j += P_QUARTERS) {   // (plane, row)
          const int pl = j / P_R, r = r0 + j % P_R;
          if (r < rows)
            cp_async4(xb + j * P_QS + kk, (pl ? xdi : xdr) + (size_t)r * BINS + k0 + kk);
        }
      cp_async_commit();
    };
    auto issue_basis = [&](int c) {             // a warp a (plane, bin) row of 128
      const int k0 = c * P_KC, nk = min(P_KC, BINS - k0);
      float* bb = bbuf + (c % P_STAGES) * P_BBUF;
      for (int j = p / 32; j < 2 * nk; j += P_PROD / 32) {
        const int pl = j % 2, b = j / 2;
        cp_async16(bb + (pl * P_KC + b) * FPB + 4 * lane,
                   (pl ? ici : icr) + (size_t)(k0 + b) * FPB + 4 * lane);
      }
      cp_async_commit();
    };
    issue_rows(0);
    for (int c = 0; c < P_CHUNKS; ++c) {
      bar_sync(BAR_PROD, P_PROD);               // every producer is past chunk c-1's blend
      if (c >= P_STAGES)                        // the consumers are past chunk c - P_STAGES
        bar_sync(BAR_FREE + c % P_STAGES, P_THREADS);
      issue_basis(c);
      if (c + 1 < P_CHUNKS)
        issue_rows(c + 1);
      else
        cp_async_commit();
      cp_async_wait<2>();                       // chunk c's table windows and XD
      bar_sync(BAR_PROD, P_PROD);
      const int k0 = c * P_KC, nk = min(P_KC, BINS - k0);
      const float* rb = rbuf + (c & 1) * P_RBUF;
      const float* xb = xbuf + (c & 1) * P_XBUF;
      float* qr = qbuf + (c % P_STAGES) * P_QBUF;
      float* qi = qr + P_KC * P_QLD;
      if (kk < nk)
        for (int e = quarter; e < ne; e += P_QUARTERS) {
          const int u0 = user[e][0], u1 = user[e][1];
          if (u0 < 0 && u1 < 0) continue;
          float g[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float wj = ent[e].w[j];
            // staged: plane pl's bin kk at pl*P_WIN + pl + kk of the row's windows
            const float* trow = staged ? rb + ent_d[e][j] * P_RD + kk
                                       : src.table + (size_t)ent[e].id[j] * C4 + k0 + kk;
            const int stride = staged ? P_WIN + 1 : BINS;
#pragma unroll
            for (int pl = 0; pl < 4; ++pl) {
              const float v = __fmul_rn(wj, trow[pl * stride]);
              g[pl] = j == 0 ? v : __fadd_rn(g[pl], v);
            }
          }
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const int u = side ? u1 : u0;
            if (u < 0) continue;
            const float xr = xb[u * P_QS + kk], xi = xb[(P_R + u) * P_QS + kk];
#pragma unroll
            for (int ear = 0; ear < 2; ++ear) {
              const int m = kk * P_QLD + (side * 2 + ear) * P_R + u;
              cmul_rn(xr, xi, g[2 * ear], g[2 * ear + 1], &qr[m], &qi[m]);
            }
          }
        }
      cp_async_wait<1>();                       // chunk c's basis
      __syncwarp();                             // the warp's lanes reconverge
      bar_arrive(BAR_FULL + c % P_STAGES, P_THREADS);
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P_CONS_REGS));
    const int tx = tid % 16, ty = tid / 16;
    float acc[16][8];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < P_CHUNKS; ++c) {
      bar_sync(BAR_FULL + c % P_STAGES, P_THREADS);
      const float* qr = qbuf + (c % P_STAGES) * P_QBUF;
      const float* br = bbuf + (c % P_STAGES) * P_BBUF;
      staged_chunk_fma(acc, qr, qr + P_KC * P_QLD, br, br + P_KC * FPB, tx, ty,
                       min(P_KC, BINS - c * P_KC));
      if (c + P_STAGES < P_CHUNKS) bar_arrive(BAR_FREE + c % P_STAGES, P_THREADS);
    }
    bar_sync(BAR_CONS, P_CONS);                 // every consumer is done with the buffers
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(y + (ty * 16 + i) * FPB + tx * 4 + 64 * g) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    bar_sync(BAR_CONS, P_CONS);                 // the tile's tails are in y

    // crossfade epilogue, launch B's: out[r] = [L 128 | R 128]
    for (int i = tid; i < P_R * 2 * FPB; i += P_CONS) {
      const int row = i / (2 * FPB), col = i % (2 * FPB), r = r0 + row;
      if (r >= rows) break;
      const int ear = col / FPB, t = col % FPB;
      const float y_old = y[(ear * P_R + row) * FPB + t];
      const float y_new = y[((2 + ear) * P_R + row) * FPB + t];
      const float fn = (float)t / (float)(FPB - 1);
      const bool on = xf[r] > 0.f;
      const float a = on ? __fsub_rn(1.f, fn) : 0.f;
      const float b = on ? fn : 1.f;
      out[(size_t)r * 2 * FPB + col] = __fadd_rn(__fmul_rn(y_old, a), __fmul_rn(y_new, b));
    }
  }
}

#endif  // JT_TUNED_128: the staged form

#if JT_TUNED_128
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
#endif  // JT_TUNED_128: the cluster form

}  // namespace

// One fused step.  Launch A runs the forward over num_sources streams of
// nb blocks each and writes the XD planes to the caller's scratch (xdr,
// xdi: rows x 513 each, rows = num_sources * nb; pr, pi: its planes form's
// sub-block DFTs, num_sources * (nb + Q - 1) rows x 513 each, null where
// the step takes another form); launch B writes out (rows x 256).  Every pointer is device memory; dsel is null for per-row
// distance (uh/ul/fr then have one entry per row), else it selects each
// row's triple among the first n_dist.  table holds u_rows rows per group
// of group_rows output rows; bnd_idx/bnd_w hold one row per seg output
// rows; blocked_tail != 0 sums the tail by 128-bin blocks.  form: the
// blocked tail's launch B as FORM_LAUNCH_B (one CTA per 32 rows) or
// FORM_SPLIT (a cluster of CTAs per tile, fused_forward.cuh: the same
// bits; it needs group_rows % seg == 0); one chain over K as FORM_LAUNCH_B
// or FORM_STAGED (blend_tail_staged: the same bits; it needs group_rows %
// seg == 0); anything else, a form the geometry lacks, or a history of
// partial blocks (no launch A) is refused (cudaErrorInvalidValue).
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
    float* xdr, float* xdi, float* pr, float* pi, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (!(form == FORM_LAUNCH_B ||
          (form == FORM_SPLIT && HAS_SPLIT && blocked_tail && group_rows % seg == 0) ||
          (form == FORM_STAGED && JT_TUNED_128 && !blocked_tail && group_rows % seg == 0)))
      return cudaErrorInvalidValue;
    cudaError_t err = launch_forward_distance(s, streams, num_sources, nb, uh, ul, fr,
                                              dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi, pr,
                                              pi);
    if (err != cudaSuccess) return err;
    const int rows = num_sources * nb;
    const RowsBlended src{table, u_rows, ridx, w, bnd_idx, bnd_w, group_rows};
#if JT_TUNED_128
    if (form == FORM_STAGED) {
      err = allow_smem_once(blend_tail_staged, P_SMEM, staged_smem_set);
      if (err != cudaSuccess) return err;
      blend_tail_staged<<<(rows + P_R - 1) / P_R, P_THREADS, P_SMEM, s>>>(
          xdr, xdi, rows, seg, src, xf, icr, ici, out);
      return cudaGetLastError();
    }
#endif
    if (form == FORM_SPLIT)
      return launch_split_tail<2>(s, xdr, xdi, rows, seg, src, xf, icr, ici, out);
    return blocked_tail ? launch_blend_tail<true>(s, xdr, xdi, rows, table, u_rows, ridx, w,
                                                  bnd_idx, bnd_w, seg, group_rows, xf, icr, ici,
                                                  out)
                        : launch_blend_tail<false>(s, xdr, xdi, rows, table, u_rows, ridx, w,
                                                   bnd_idx, bnd_w, seg, group_rows, xf, icr, ici,
                                                   out);
  });
}

// Launch A alone in ``form`` (FWD_TILE, FWD_PRODUCT, FWD_FEW, FWD_PLANES or
// FWD_RING of fused_forward.cuh, the planes form with its scratch pr, pi,
// or one of its two launches, FWD_PLANES_DFT or FWD_PLANES_SUM; anything
// else is refused): the XD planes (xdr, xdi: rows x 513, rows = num_sources * nb)
// of num_sources streams of nb blocks, with per-row distance or, with dsel,
// each row's triple among the first n_dist.  The card tests and chip_smoke.py hold
// the forms against each other through it.  Launches on ``stream`` of
// ``device`` without synchronising and returns the first CUDA error.
extern "C" int jt_forward_distance(
    int device, void* stream, int form, const float* streams, int num_sources, int nb,
    const float* uh, const float* ul, const float* fr, const int* dsel, int n_dist,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi, float* pr, float* pi) {
  return on_device(device, [&]() {
    return launch_forward_form(form, static_cast<cudaStream_t>(stream), streams, num_sources,
                               nb, uh, ul, fr, dsel, n_dist, cfr, cfi, twr, twi, xdr, xdi, pr,
                               pi);
  });
}

// Row 8, the full-table blend-apply-tail step (jefferson_tpu/pallas/
// fused_spatializer.py _kernel :46 of fused_apply :102): every row's old
// side blends idx_old[r] and its new side idx_new[r], both against the whole
// table (table_rows rows), the blocked tail, and the crossfade where
// xf[r] > 0.  ``form`` picks launch B's form: 0 launch B with seg = 1 (one
// group), 1 the cluster form (spatializer_cluster), 2 the split form
// (fused_forward.cuh) with seg = 1; anything else, or a form the geometry
// lacks (the cluster form exists at fpb 128 / pad 1024 alone, the split
// form where HAS_SPLIT), is refused.  With
// streams null, xdr and xdi are the caller's XD planes (rows x 513); else
// launch A first writes them from one stream of rows blocks (streams:
// (rows + Q - 1) x fpb samples, history first; whole blocks of history
// only) with per-row distance uh/ul/fr
// (rows each), pr and pi its planes form's scratch (rows + Q - 1 rows x
// 513 each; null where it takes another form).  The live block step runs the cluster form at one row, the
// scan render another form at every row of a chunk.  Launches on
// ``stream`` of ``device`` without synchronising and returns the first
// CUDA error.
extern "C" int jt_fused_spatializer_apply(
    int device, void* stream, int rows, int form,
    const float* streams, const float* uh, const float* ul, const float* fr,
    const float* cfr, const float* cfi, const float* twr, const float* twi,
    float* xdr, float* xdi, float* pr, float* pi,
    const float* table, int table_rows, const int* idx_old, const float* w_old,
    const int* idx_new, const float* w_new, const float* xf,
    const float* icr, const float* ici, float* out) {
  return on_device(device, [&]() {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (form < 0 || form > 2 || (form == 1 && !JT_TUNED_128) || (form == 2 && !HAS_SPLIT))
      return cudaErrorInvalidValue;
    cudaError_t err = cudaSuccess;
    if (streams)
      err = launch_forward_distance(s, streams, 1, rows, uh, ul, fr, nullptr, 0,
                                    cfr, cfi, twr, twi, xdr, xdi, pr, pi);
    if (err != cudaSuccess) return err;
#if JT_TUNED_128
    if (form == 1) {
      err = cudaFuncSetAttribute(spatializer_cluster,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C_SMEM);
      if (err != cudaSuccess) return err;
      spatializer_cluster<<<C_BLOCKS * rows, C_THREADS, C_SMEM, s>>>(
          xdr, xdi, table, table_rows, idx_old, w_old, idx_new, w_new, xf, icr, ici, out);
      return cudaGetLastError();
    }
#endif
    if (form == 2)
      return launch_split_tail<2>(
          s, xdr, xdi, rows, 1,
          RowsBlended{table, table_rows, idx_old, w_old, idx_new, w_new, rows}, xf, icr, ici,
          out);
    return launch_blend_tail<true>(s, xdr, xdi, rows, table, table_rows, idx_old, w_old,
                                   idx_new, w_new, 1, rows, xf, icr, ici, out);
  });
}

