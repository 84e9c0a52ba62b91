// Double-buffered row-gather blend for Hopper (sm_90a): per output row r,
//
//   out[r] = w0*T[i0] + w1*T[i1] + w2*T[i2] + w3*T[i3]     (in that order)
//
// from a flat table whose rows are padded to c_pad floats.
//
// Replaces the TPU kernel of scripts/bench_blend_variants.py
// pallas_dma_blend (:98), body ``kernel`` (:55): per tile of rows it starts
// the row copies of bracket k+1 into one VMEM slot while it accumulates
// bracket k from the other.  The port asks the same question of the card:
// whether staging the bracket rows in shared memory with asynchronous
// copies beats the plain gathers through L2 (the torch variants of
// jefferson_tpu_torch/scripts/bench_blend_variants.py, and launch B of
// rows 1-8).
//
// What bounds it on the H100: bytes.  At the script's shape (8,448 rows of
// 2,176 floats, a 710-row table) it writes 73.5 MB and reads the table's
// named rows once and the ids and weights: about 80 MB, 0.024 ms at
// 3.35 TB/s.  Each output row reads four table rows, so the gathers move
// 294 MB through L2 (the whole table, 6.2 MB, stays in the 50 MB L2).
//
// Two forms, the same bits (the entry's ``form``):
//
// The double-buffered form (dma_blend_kernel), the first.  The TPU tile (256
// rows, 2.2 MB a slot) does not fit a CTA: a CTA takes 8 rows x 1,024
// columns (the last column slice ragged), two slots of 32 KB, 64 KB in
// all.  The CTA loads its own ids and weights (no scalar prefetch); each
// of the 256 threads owns one float4 column of the slice: it issues its 8
// rows' 16-byte cp.async for bracket k+1 into one slot, waits for bracket
// k's group, and accumulates from the other slot into 8 float4 registers;
// a __syncthreads before each slot is refilled keeps the copies behind the
// reads.  What held it at 2.7x its bound (PERF.md, row 12): every output
// row gathers its four table rows on its own (294 MB through L2 for 73.5 MB
// written), and at c_pad = 2,176 a third of the CTAs run 128 live columns
// of 1,024.
//
// The dedup form (dma_blend_dedup).  A CTA takes a tile of DD_ROWS = 32
// rows and walks a share of the row's column slices: the row's float4
// columns cut into n = ceil(c/128) slices of equal width (up to 32 float4;
// c_pad = 2,176: 17 of 32, c = 2,052: 16 of 31 and one of 17), so a warp's
// lanes are its float4 columns with few dead lanes.  The tile's 128 (row,
// bracket) ids are deduplicated once, through a small hash table in shared
// memory, into D distinct table rows; each slice stages those D rows once
// (16-byte cp.async, D x 512 bytes at most), so the tile reads each row it
// names once a slice instead of once a (row, bracket) (the bench workload:
// 13 distinct of 128 at 32 rows).  The slices run through a ring of
// min(4, 128 / D) stages in 64 KB, so up to four slices' copies are in
// flight while one is summed; three CTAs an SM.  A warp sums rows w, w+8,
// w+16, w+24 of the slice from shared memory and writes them with
// streaming stores (st.global.cs: the output is not read again here).
// dedup_groups CTAs share a tile's slices, enough for four waves of three
// CTAs an SM and a slice each at most: at 8,448 x 2,176, 6 a tile took
// 0.0317 ms, 3 0.0359, 1 0.0353 (PERF.md, row 12).
//
// Both round every product and sum on its own in bracket order
// (__fmul_rn/__fadd_rn), so the output is the torch gathers' bit for bit.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "entry.cuh"

namespace {

constexpr int DB_TR = 8;                      // rows per CTA
constexpr int DB_CS = 1024;                   // columns per CTA
constexpr int DB_THREADS = DB_CS / 4;         // one float4 column each
constexpr int DB_BRACKETS = 4;
constexpr size_t DB_SMEM = 2 * DB_TR * DB_CS * sizeof(float);   // two slots: 64 KB

std::atomic<unsigned long long> double_smem_set{0};

__global__ void __launch_bounds__(DB_THREADS)
dma_blend_kernel(const float* __restrict__ table, int h, int c_pad,
                 const int* __restrict__ idx, const float* __restrict__ w,
                 float* __restrict__ out, int rows) {
  extern __shared__ float4 slots[];           // [2][DB_TR][DB_CS / 4]
  __shared__ int sid[DB_BRACKETS][DB_TR];
  __shared__ float sw[DB_BRACKETS][DB_TR];
  const int r0 = blockIdx.x * DB_TR;
  const int t = threadIdx.x;
  const int col = blockIdx.y * DB_CS + 4 * t;
  const bool live = col < c_pad;              // c_pad % 4 == 0: a float4 is in or out

  if (t < DB_BRACKETS * DB_TR) {
    const int k = t / DB_TR, j = t % DB_TR, r = r0 + j;
    int id = 0;
    float wk = 0.f;
    if (r < rows) {
      id = idx[(size_t)r * DB_BRACKETS + k];
      wk = w[(size_t)r * DB_BRACKETS + k];
      if (id < 0 || id >= h) {                // contributes nothing: row 0 at weight 0
        id = 0;
        wk = 0.f;
      }
    }
    sid[k][j] = id;
    sw[k][j] = wk;
  }
  __syncthreads();

  auto stage = [&](int k) {
    float4* slot = slots + (k & 1) * DB_TR * DB_THREADS;
    if (live) {
#pragma unroll
      for (int j = 0; j < DB_TR; ++j)
        cp_async16(slot + j * DB_THREADS + t, table + (size_t)sid[k][j] * c_pad + col);
    }
    cp_async_commit();
  };

  float4 acc[DB_TR];
  stage(0);
#pragma unroll
  for (int k = 0; k < DB_BRACKETS; ++k) {
    if (k + 1 < DB_BRACKETS) {
      stage(k + 1);
      cp_async_wait<1>();                     // bracket k's group has landed
    } else {
      cp_async_wait<0>();
    }
    const float4* slot = slots + (k & 1) * DB_TR * DB_THREADS;
#pragma unroll
    for (int j = 0; j < DB_TR; ++j) {
      const float4 v = slot[j * DB_THREADS + t];
      const float wk = sw[k][j];
      if (k == 0) {
        acc[j] = make_float4(__fmul_rn(wk, v.x), __fmul_rn(wk, v.y), __fmul_rn(wk, v.z),
                             __fmul_rn(wk, v.w));
      } else {
        acc[j].x = __fadd_rn(acc[j].x, __fmul_rn(wk, v.x));
        acc[j].y = __fadd_rn(acc[j].y, __fmul_rn(wk, v.y));
        acc[j].z = __fadd_rn(acc[j].z, __fmul_rn(wk, v.z));
        acc[j].w = __fadd_rn(acc[j].w, __fmul_rn(wk, v.w));
      }
    }
    __syncthreads();                          // this slot is refilled by bracket k+2
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < DB_TR; ++j)
    if (r0 + j < rows) *reinterpret_cast<float4*>(out + (size_t)(r0 + j) * c_pad + col) = acc[j];
}


// ---- the dedup form ---------------------------------------------------------
constexpr int DD_ROWS = 32;                   // rows a tile
constexpr int DD_SLOTS = DB_BRACKETS * DD_ROWS;   // (row, bracket) ids a tile: 128
constexpr int DD_THREADS = 256;               // 8 warps x 4 rows; a lane a float4 column
constexpr int DD_W4 = 32;                     // float4 columns a slice, at most
constexpr int DD_STAGES = 4;                  // slices in flight, at most
constexpr int DD_HASH = 256;                  // open-addressed id table, 2x the slots
constexpr size_t DD_SMEM = (size_t)DD_SLOTS * DD_W4 * sizeof(float4);   // 64 KB
constexpr int DD_WANT_CTAS = 1584;            // four waves of three CTAs on 132 SMs
static_assert(DD_ROWS == 4 * (DD_THREADS / 32), "a warp sums four rows of a tile");

std::atomic<unsigned long long> dedup_smem_set{0};

// CTAs that share a tile's column slices in the dedup form at ``rows``
// rows of c floats: enough for DD_WANT_CTAS, at most a slice each.
inline int dedup_groups(int rows, int c) {
  const int tiles = (rows + DD_ROWS - 1) / DD_ROWS;
  const int n_slices = (c / 4 + DD_W4 - 1) / DD_W4;
  if (tiles < 1) return 1;                      // no CTA: the launch is refused
  const int want = (DD_WANT_CTAS + tiles - 1) / tiles;
  return want < 1 ? 1 : want > n_slices ? n_slices : want;
}

__global__ void __launch_bounds__(DD_THREADS)
dma_blend_dedup(const float* __restrict__ table, int h, int c, const int* __restrict__ idx,
                const float* __restrict__ w, float* __restrict__ out, int rows, int groups) {
  extern __shared__ float4 stage[];           // [ring stage][distinct row][DD_W4]
  __shared__ int key[DD_HASH];                // the id in each hash slot, or -1
  __shared__ int key_row[DD_HASH];            // its staged row
  __shared__ int distinct[DD_SLOTS];          // staged row -> table id
  __shared__ int slot_row[DD_SLOTS];          // (row, bracket) -> staged row
  __shared__ float slot_w[DD_SLOTS];
  __shared__ int n_distinct;

  const int tid = threadIdx.x;
  const int r0 = (blockIdx.x / groups) * DD_ROWS;
  const int g = blockIdx.x % groups;
  const int c4 = c / 4;
  const int n_slices = (c4 + DD_W4 - 1) / DD_W4;
  const int w4 = (c4 + n_slices - 1) / n_slices;      // equal slices, the last may be short
  const int s_begin = g * n_slices / groups, s_end = (g + 1) * n_slices / groups;

  for (int i = tid; i < DD_HASH; i += DD_THREADS) key[i] = -1;
  if (tid == 0) n_distinct = 0;
  __syncthreads();
  int hslot = 0;
  if (tid < DD_SLOTS) {
    // an id outside [0, h) contributes nothing: row 0 at weight 0; rows past
    // the end read row 0 and are not written
    const int r = r0 + tid / DB_BRACKETS;
    int id = 0;
    float wk = 0.f;
    if (r < rows) {
      id = idx[(size_t)r0 * DB_BRACKETS + tid];
      wk = w[(size_t)r0 * DB_BRACKETS + tid];
      if (id < 0 || id >= h) {
        id = 0;
        wk = 0.f;
      }
    }
    slot_w[tid] = wk;
    hslot = (int)(((unsigned)id * 2654435761u) >> 24) & (DD_HASH - 1);
    for (;;) {
      const int prev = atomicCAS(&key[hslot], -1, id);
      if (prev == -1) {                       // first of its id: give it a staged row
        const int d = atomicAdd(&n_distinct, 1);
        key_row[hslot] = d;
        distinct[d] = id;
        break;
      }
      if (prev == id) break;
      hslot = (hslot + 1) & (DD_HASH - 1);
    }
  }
  __syncthreads();
  if (tid < DD_SLOTS) slot_row[tid] = key_row[hslot];
  __syncthreads();
  const int nd = n_distinct;
  const int ring = min(DD_STAGES, DD_SLOTS / nd);   // stages that fit 64 KB

  // stage slice s into ring stage b: the nd distinct rows' w4 float4 columns
  auto issue = [&](int s, int b) {
    if (s < s_end) {
      const int col0 = s * w4, width = min(w4, c4 - col0);
      float4* dst = stage + (size_t)b * nd * DD_W4;
      for (int i = tid; i < nd * width; i += DD_THREADS) {
        const int d = i / width, cc = i - d * width;
        cp_async16(dst + d * DD_W4 + cc, table + (size_t)distinct[d] * c + 4 * (col0 + cc));
      }
    }
    cp_async_commit();                        // one group a stage, empty or not
  };

  const int lane = tid % 32, warp = tid / 32;
  for (int b = 0; b < ring; ++b) issue(s_begin + b, b);
  for (int s = s_begin, i = 0; s < s_end; ++s, ++i) {
    cp_async_wait_n(ring - 1);                // slice s's group has landed
    __syncthreads();
    const int col0 = s * w4, width = min(w4, c4 - col0);
    const float4* src = stage + (size_t)(i % ring) * nd * DD_W4;
    if (lane < width) {
#pragma unroll
      for (int j = 0; j < DD_ROWS / 8; ++j) {
        const int row = warp + 8 * j, r = r0 + row;
        if (r >= rows) break;
        float4 acc;
#pragma unroll
        for (int k = 0; k < DB_BRACKETS; ++k) {
          const int sl = row * DB_BRACKETS + k;
          const float4 v = src[slot_row[sl] * DD_W4 + lane];
          const float wk = slot_w[sl];
          if (k == 0) {
            acc = make_float4(__fmul_rn(wk, v.x), __fmul_rn(wk, v.y), __fmul_rn(wk, v.z),
                              __fmul_rn(wk, v.w));
          } else {
            acc.x = __fadd_rn(acc.x, __fmul_rn(wk, v.x));
            acc.y = __fadd_rn(acc.y, __fmul_rn(wk, v.y));
            acc.z = __fadd_rn(acc.z, __fmul_rn(wk, v.z));
            acc.w = __fadd_rn(acc.w, __fmul_rn(wk, v.w));
          }
        }
        __stcs(reinterpret_cast<float4*>(out + (size_t)r * c + 4 * (col0 + lane)), acc);
      }
    }
    __syncthreads();                          // this stage is refilled next
    issue(s + ring, i % ring);
  }
  cp_async_wait<0>();                         // no copy outlives the CTA
}

}  // namespace

// Dynamic shared memory of one CTA of the double-buffered form, in bytes.
extern "C" long long jt_dma_blend_smem_bytes() { return (long long)DB_SMEM; }

// out (rows x c) from table (h x c, flat, 16-byte aligned), idx and w (rows
// x 4, int32 and float32); c a multiple of 4.  ``form`` 0 the
// double-buffered form, 1 the dedup form; anything else is refused.
// Launches on ``stream`` of ``device`` without synchronising and returns
// the first CUDA error (rows < 1 is an invalid launch).
extern "C" int jt_dma_blend_form(int device, void* stream, int form, const float* table, int h,
                                 int c, const int* idx, const float* w, float* out, int rows) {
  return on_device(device, [&]() {
    if ((form != 0 && form != 1) || c < 4 || c % 4) return cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (form == 0) {
      cudaError_t err = allow_smem_once(dma_blend_kernel, DB_SMEM, double_smem_set);
      if (err != cudaSuccess) return err;
      const dim3 grid((rows + DB_TR - 1) / DB_TR, (c + DB_CS - 1) / DB_CS);
      dma_blend_kernel<<<grid, DB_THREADS, DB_SMEM, st>>>(table, h, c, idx, w, out, rows);
      return cudaGetLastError();
    }
    cudaError_t err = allow_smem_once(dma_blend_dedup, DD_SMEM, dedup_smem_set);
    if (err != cudaSuccess) return err;
    const int g = dedup_groups(rows, c);
    const int tiles = (rows + DD_ROWS - 1) / DD_ROWS;
    dma_blend_dedup<<<tiles * g, DD_THREADS, DD_SMEM, st>>>(table, h, c, idx, w, out, rows, g);
    return cudaGetLastError();
  });
}
