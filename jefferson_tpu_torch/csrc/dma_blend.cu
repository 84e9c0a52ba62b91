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
// Design.  The TPU tile (256 rows, 2.2 MB a slot) does not fit a CTA: a
// CTA takes 8 rows x 1,024 columns (the last column slice ragged), two
// slots of 32 KB, 64 KB in all, above the 48 KB a launch gets unasked, so
// the entry raises the kernel's limit with cudaFuncSetAttribute and checks
// the launch with cudaGetLastError.  The CTA loads its own ids and weights
// (no scalar prefetch); an id outside [0, H) reads row 0 at weight 0, as
// the twin does, so the kernel never reads outside the table.  Each of the
// 256 threads owns one float4 column of the slice: it issues its 8 rows'
// 16-byte cp.async for bracket k+1 into one slot, waits for bracket k's
// group, and accumulates from the other slot into 8 float4 registers; a
// __syncthreads before each slot is refilled keeps the copies behind the
// reads.  Products and sums are __fmul_rn/__fadd_rn in bracket order, so
// the output is the torch gathers' bit for bit.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "entry.cuh"

namespace {

constexpr int DB_TR = 8;                      // rows per CTA
constexpr int DB_CS = 1024;                   // columns per CTA
constexpr int DB_THREADS = DB_CS / 4;         // one float4 column each
constexpr int DB_BRACKETS = 4;
constexpr size_t DB_SMEM = 2 * DB_TR * DB_CS * sizeof(float);   // two slots: 64 KB

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

}  // namespace

// Dynamic shared memory of one CTA, in bytes.
extern "C" long long jt_dma_blend_smem_bytes() { return (long long)DB_SMEM; }

// out (rows x c_pad) from table (h x c_pad, flat, 16-byte aligned), idx and
// w (rows x 4, int32 and float32); c_pad a multiple of 4.  Launches on
// ``stream`` of ``device`` without synchronising and returns the first
// CUDA error (rows < 1 is an invalid launch).
extern "C" int jt_dma_blend(int device, void* stream, const float* table, int h, int c_pad,
                            const int* idx, const float* w, float* out, int rows) {
  return on_device(device, [&]() {
    cudaError_t err = cudaFuncSetAttribute(
        dma_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DB_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((rows + DB_TR - 1) / DB_TR, (c_pad + DB_CS - 1) / DB_CS);
    dma_blend_kernel<<<grid, DB_THREADS, DB_SMEM, static_cast<cudaStream_t>(stream)>>>(
        table, h, c_pad, idx, w, out, rows);
    return cudaGetLastError();
  });
}
