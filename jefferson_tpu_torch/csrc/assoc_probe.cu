// The apply-association probe's kernels for Hopper (sm_90a): the complex
// product of the fused apply stage and its tail-IDFT matmul, whose
// rounding the probe (jefferson_tpu_torch/scripts/apply_assoc_probe.py)
// holds against eager torch, cuBLAS and float64.
//
// Replaces the TPU kernels of scripts/apply_assoc_probe.py:
//   row 9   prod_pallas (:69), body _prod_kernel (:60):
//             qr = xr*gr - xi*gi,  qi = xr*gi + xi*gr, elementwise;
//   row 10  mm_pallas (:97), body _mm_kernel (:84):
//             y = qr @ icr + qi @ ici, fp32: two contractions, then one add;
//   row 11  mm_pallas_tree (:145), body _mm_tree_kernel (:116): the same
//             with K cut into ``chunks`` slices, each plane's chunk products
//             summed by the probe's tree() (pairwise, an odd part carried),
//             then real + imag.
//
// Row 9 writes the plain expressions and lets nvcc contract them (the
// build does not pass --fmad=false): what the compiler does to a*b - c*d is
// the question stage A asks.  ptxas (CUDA 12.8, sm_90a) emits one FMUL and
// one FFMA for each output: qr = fma(xr, gr, -rn(xi*gi)) and
// qi = fma(xi, gr, rn(xr*gi)) (cuobjdump -sass of the build; the probe's
// per-plane counts agree on every element), where eager torch rounds both
// products.  qr is XLA's contraction on the CPU; qi keeps the other product.
//
// Row 10 is row 11 with one chunk: one chain per plane in ascending k.
//
// What bounds them on the H100: at the probe's shapes (256 rows, K = 513 or
// 512, 128 columns) row 9 moves 3.15 MB (0.94 us at 3.35 TB/s) and rows
// 10-11 do 67 MFLOP (1.0 us at 67 TFLOP/s fp32), so every one of them is
// bound by its launch.  Design: row 9 one thread per element.  Rows 10-11
// one CTA of 128 threads per 4 rows x 128 columns; the CTA's q rows (both
// planes, all of K) sit in shared memory and every thread reads them by
// broadcast; each thread owns one column and walks K through the basis in
// device memory (L2-resident, 263 KB a plane), each basis element feeding
// the CTA's 4 rows from a register.  Each output keeps one fp32 register
// per (row, chunk) and sums the chunk's terms with fmaf in ascending k, the
// real plane's chain apart from the imaginary one: the JAX body's
// dot + dot.  No tensor cores: TF32 would round the operands.

#include <cuda_runtime.h>

#include "entry.cuh"

namespace {

constexpr int PROD_THREADS = 256;
constexpr int MM_TM = 4;            // rows per CTA
constexpr int MM_TN = 128;          // columns per CTA: one thread each
constexpr int MAX_CHUNKS = 16;      // K slices of row 11
constexpr int TREE_LEVELS = 4;      // log2(MAX_CHUNKS)

__global__ void __launch_bounds__(PROD_THREADS)
prod_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
            const float* __restrict__ gr, const float* __restrict__ gi,
            float* __restrict__ qr, float* __restrict__ qi, long long n) {
  const long long i = (long long)blockIdx.x * PROD_THREADS + threadIdx.x;
  if (i >= n) return;
  const float a = xr[i], b = xi[i], c = gr[i], d = gi[i];
  qr[i] = a * c - b * d;
  qi[i] = a * d + b * c;
}

// The probe's tree() in place on parts[0..n): each level adds neighbours
// pairwise, an odd last part carried, until one is left.  Part i of a level
// reads parts 2i and 2i+1, which no earlier write of the level touched.
__device__ __forceinline__ float tree_sum(float (&p)[MAX_CHUNKS], int n) {
#pragma unroll
  for (int level = 0; level < TREE_LEVELS; ++level) {
#pragma unroll
    for (int i = 0; i < MAX_CHUNKS / 2; ++i)
      if (2 * i < n) p[i] = 2 * i + 1 < n ? __fadd_rn(p[2 * i], p[2 * i + 1]) : p[2 * i];
    n = (n + 1) / 2;
  }
  return p[0];
}

__global__ void __launch_bounds__(MM_TN)
mm_tree_kernel(const float* __restrict__ qr, const float* __restrict__ qi,
               const float* __restrict__ icr, const float* __restrict__ ici,
               float* __restrict__ y, int m, int k, int n, int chunks) {
  extern __shared__ float sq[];     // [plane][MM_TM][k]
  const int r0 = blockIdx.x * MM_TM;
  const int col = blockIdx.y * MM_TN + threadIdx.x;
  for (int i = threadIdx.x; i < 2 * MM_TM * k; i += MM_TN) {
    const int plane = i / (MM_TM * k), row = i / k % MM_TM, kk = i % k, r = r0 + row;
    sq[i] = r < m ? (plane ? qi : qr)[(size_t)r * k + kk] : 0.f;
  }
  __syncthreads();
  if (col >= n) return;

  const int ck = k / chunks;
  float y_plane[2][MM_TM];
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
    const float* basis = plane ? ici : icr;
    const float* q = sq + plane * MM_TM * k;
    float part[MM_TM][MAX_CHUNKS];
#pragma unroll
    for (int c = 0; c < MAX_CHUNKS; ++c) {
      float acc[MM_TM] = {};
      if (c < chunks) {
        for (int kk = c * ck; kk < (c + 1) * ck; ++kk) {
          const float b = basis[(size_t)kk * n + col];
#pragma unroll
          for (int i = 0; i < MM_TM; ++i) acc[i] = fmaf(q[i * k + kk], b, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MM_TM; ++i) part[i][c] = acc[i];
    }
#pragma unroll
    for (int i = 0; i < MM_TM; ++i) y_plane[plane][i] = tree_sum(part[i], chunks);
  }
#pragma unroll
  for (int i = 0; i < MM_TM; ++i)
    if (r0 + i < m) y[(size_t)(r0 + i) * n + col] = __fadd_rn(y_plane[0][i], y_plane[1][i]);
}

}  // namespace

// Row 9 on n elements of four planes.  Launches on ``stream`` of ``device``
// without synchronising and returns the first CUDA error.
extern "C" int jt_prod(int device, void* stream, const float* xr, const float* xi,
                       const float* gr, const float* gi, float* qr, float* qi, long long n) {
  return on_device(device, [&]() {
    const long long blocks = (n + PROD_THREADS - 1) / PROD_THREADS;
    prod_kernel<<<(unsigned)blocks, PROD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        xr, xi, gr, gi, qr, qi, n);
    return cudaGetLastError();
  });
}

// Rows 10 (chunks = 1) and 11: y (m x n) = tree over chunks of qr @ icr,
// plus the same of qi @ ici; q planes m x k, basis planes k x n, chunks in
// 1..16 dividing k, all row-major.  Launches on ``stream`` of ``device``
// without synchronising and returns the first CUDA error.
extern "C" int jt_mm_tree(int device, void* stream, const float* qr, const float* qi,
                          const float* icr, const float* ici, float* y, int m, int k, int n,
                          int chunks) {
  return on_device(device, [&]() {
    if (chunks < 1 || chunks > MAX_CHUNKS || k % chunks) return cudaErrorInvalidValue;
    const int smem = (int)sizeof(float) * 2 * MM_TM * k;   // both planes' q rows
    cudaError_t err = cudaFuncSetAttribute(
        mm_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((m + MM_TM - 1) / MM_TM, (n + MM_TN - 1) / MM_TN);
    mm_tree_kernel<<<grid, MM_TN, smem, static_cast<cudaStream_t>(stream)>>>(
        qr, qi, icr, ici, y, m, k, n, chunks);
    return cudaGetLastError();
  });
}
