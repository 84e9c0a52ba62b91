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
// Rows 10 and 11 are one kernel; row 10 is row 11 with one chunk.
//
// The function rows 10-11 keep, bit for bit: for each (plane, output,
// chunk) one fmaf chain that starts at 0 and runs over the chunk's k in
// ascending order; the chunk partials of each plane summed by tree_sum;
// then y = rn(y_real + y_imag).  No tensor cores: TF32 would round the
// operands.
//
// What bounds them on the H100: at the probe's shapes (256 rows, K = 513 or
// 512, 128 columns) row 9 moves 3.15 MB (0.94 us at 3.35 TB/s) and rows
// 10-11 do 67 MFLOP (1.0 us at 67 TFLOP/s fp32).  Row 10's chain of 513
// dependent FMAs per plane is its floor (4.44 cycles a step, 1.1 us).
//
// Design.  Row 9: one thread per element.
//
// Rows 10-11 (mm_kernel): a CTA owns a 16 x 16 output tile of both planes
// and walks all of K, in 32-bin tiles through a ring of four shared-memory
// stages, with its warps in two roles.  Eight producer warps load the q rows
// and basis columns of the tiles two ahead into registers (16-byte loads of
// the basis where its rows allow), store them into a free stage and arrive
// on its named barrier; four consumer warps wait on it, sum it, and free
// it.  A consumer thread keeps a 2 x 2 register tile of one plane: four
// chains, each q value it reads feeding two FMAs, each basis value two; q is
// stored [plane][row][k] and the basis [plane][column][k], so each reads
// four bins at once.  At a chunk's end a consumer stores its four partials
// into shared memory and starts again from 0; after the last tile it sums
// each output's partials by tree_sum.  The imaginary plane's sums then pass
// to the real plane's threads through shared memory: y = rn(y_real +
// y_imag).  128 CTAs at the probe's 256 x 513 x 128; any K.
//
// What bounds it on the card (H100 80GB HBM3, 700 W).  The consumers, not
// the chain: a 16-byte shared-memory load costs a warp four cycles whatever
// it broadcasts, and four warps of 2 x 2 tiles read 64 bytes a thread a
// four-bin group, so the loop runs several cycles a bin over the chain's
// FMA latency.  More threads with fewer chains each read more bytes a bin;
// fewer threads with more chains each are no faster.  The producers' 16.8
// MB from L2 (16 x 16 tiles) take about as long again, and the two overlap
// only in part.  cuBLAS (32 x 32 tiles, 8.4 MB) stays ahead at these shapes
// (chip_smoke.py, phase bench).

#include <cuda_runtime.h>

#include "entry.cuh"

namespace {

constexpr int PROD_THREADS = 256;
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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- rows 10-11 ---------------------------------------------------------------
constexpr int MM_BM = 16, MM_BN = 16;       // output tile, both planes
constexpr int MM_BK = 32;                   // bins a stage
constexpr int MM_KS = MM_BK + 4;            // row stride of q [plane][row][k] and the basis [plane][col][k]
constexpr int MM_QF = 2 * MM_BM * MM_KS;    // floats of a stage's q
constexpr int MM_STAGE = MM_QF + 2 * MM_BN * MM_KS;
constexpr int MM_STAGES = 4;                // the ring
constexpr int MM_AHEAD = 2;                 // tiles a producer holds in registers
constexpr int MM_CONS = 128;                // consumers: 2 planes x 64 threads x (2 x 2)
constexpr int MM_PROD = 256;
constexpr int MM_THREADS = MM_CONS + MM_PROD;
constexpr int MM_NQ = 2 * MM_BM * MM_BK / MM_PROD;   // q floats a producer loads a tile: 4
constexpr int MM_NB = 2 * MM_BK * MM_BN / MM_PROD;   // basis floats: 4
// named barriers: 0 is __syncthreads; stage s is full at 1 + s, free at
// 1 + MM_STAGES + s; the consumers' own after them
constexpr int MM_BAR_CONS = 1 + 2 * MM_STAGES;
static_assert(MM_NB == 4, "one basis float4 (or four floats) a producer a tile");
static_assert(MM_BAR_CONS < 16, "16 named barriers");

// A producer's share of a tile: its q floats and four of the basis.
struct Slot {
  float q[MM_NQ];
  float4 b;
};

// Load this producer's share of the tile at bins [k0, k0 + MM_BK) (zero past
// K, the last row or column).  ``vec``: the basis rows are whole 16-byte
// pieces (n % 4 == 0, aligned planes).
__device__ __forceinline__ void mm_load(Slot& s, int p, const float* __restrict__ qr,
                                        const float* __restrict__ qi,
                                        const float* __restrict__ icr,
                                        const float* __restrict__ ici, int m, int k, int n,
                                        int r0, int c0, int k0, bool vec) {
#pragma unroll
  for (int u = 0; u < MM_NQ; ++u) {         // [plane][row][kk], kk fastest: coalesced
    const int i = p + u * MM_PROD;
    const int plane = i / (MM_BM * MM_BK), row = i / MM_BK % MM_BM, kk = i % MM_BK;
    const int r = r0 + row, kq = k0 + kk;
    s.q[u] = r < m && kq < k ? __ldg((plane ? qi : qr) + (size_t)r * k + kq) : 0.f;
  }
  // [plane][kk][col / 4]
  const int plane = p / (MM_BK * MM_BN / 4), kk = p / (MM_BN / 4) % MM_BK;
  const int kb = k0 + kk, c = c0 + 4 * (p % (MM_BN / 4));
  const float* src = (plane ? ici : icr) + (size_t)kb * n + c;
  if (vec) {
    s.b = kb < k && c < n ? __ldg(reinterpret_cast<const float4*>(src))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = kb < k && c + e < n ? __ldg(src + e) : 0.f;
    s.b = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Store a share into a stage: q as loaded, the basis transposed to [col][k].
__device__ __forceinline__ void mm_store(const Slot& s, int p, float* st) {
#pragma unroll
  for (int u = 0; u < MM_NQ; ++u) {
    const int i = p + u * MM_PROD;
    const int plane = i / (MM_BM * MM_BK), row = i / MM_BK % MM_BM, kk = i % MM_BK;
    st[(plane * MM_BM + row) * MM_KS + kk] = s.q[u];
  }
  const int plane = p / (MM_BK * MM_BN / 4), kk = p / (MM_BN / 4) % MM_BK;
  const int c = 4 * (p % (MM_BN / 4));
  float* sb = st + MM_QF + (plane * MM_BN + c) * MM_KS + kk;
  sb[0] = s.b.x;
  sb[MM_KS] = s.b.y;
  sb[2 * MM_KS] = s.b.z;
  sb[3 * MM_KS] = s.b.w;
}

// y = tree over ``chunks`` of qr @ icr, plus the same of qi @ ici.  PER_K:
// a chunk's width is not a whole number of stages, so a chunk may end
// inside one (checked at every bin).
template <bool PER_K>
__global__ void __launch_bounds__(MM_THREADS)
mm_kernel(const float* __restrict__ qr, const float* __restrict__ qi,
          const float* __restrict__ icr, const float* __restrict__ ici, float* __restrict__ y,
          int m, int k, int n, int chunks, int vec) {
  extern __shared__ float smem[];           // the stages, then the chunk partials
  const int r0 = blockIdx.x * MM_BM, c0 = blockIdx.y * MM_BN;
  const int tiles = (k + MM_BK - 1) / MM_BK, ck = k / chunks;

  if (threadIdx.x >= MM_CONS) {             // producers
    const int p = threadIdx.x - MM_CONS;
    Slot slot[MM_AHEAD];
#pragma unroll
    for (int d = 0; d < MM_AHEAD; ++d)
      if (d < tiles) mm_load(slot[d], p, qr, qi, icr, ici, m, k, n, r0, c0, d * MM_BK, vec);
    for (int t0 = 0; t0 < tiles; t0 += MM_AHEAD) {
#pragma unroll
      for (int d = 0; d < MM_AHEAD; ++d) {
        const int tile = t0 + d;
        if (tile >= tiles) break;
        const int s = tile % MM_STAGES;
        if (tile >= MM_STAGES) bar_sync(1 + MM_STAGES + s, MM_THREADS);   // stage s is free
        mm_store(slot[d], p, smem + s * MM_STAGE);
        if (tile + MM_AHEAD < tiles)
          mm_load(slot[d], p, qr, qi, icr, ici, m, k, n, r0, c0, (tile + MM_AHEAD) * MM_BK, vec);
        bar_arrive(1 + s, MM_THREADS);                                    // stage s is full
      }
    }
    return;
  }

  // consumers: thread c sums rows ty, ty + 8 and columns tx, tx + 8 of one plane
  const int c = threadIdx.x, plane = c / 64, tx = c % 8, ty = c % 64 / 8;
  float* part = smem + MM_STAGES * MM_STAGE;   // [chunk][output][consumer]
  float acc[4] = {};                          // [2 * (row index) + column index]
  int chunk = 0, next = ck;                   // the bin where the current chunk ends
  auto stash = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[(chunk * 4 + e) * MM_CONS + c] = acc[e];
      acc[e] = 0.f;
    }
    ++chunk;
    next += ck;
  };
  for (int tile = 0; tile < tiles; ++tile) {
    const int s = tile % MM_STAGES;
    if (!PER_K && tile * MM_BK == next) stash();
    bar_sync(1 + s, MM_THREADS);
    const float* sq = smem + s * MM_STAGE + (plane * MM_BM + ty) * MM_KS;
    const float* sb = smem + s * MM_STAGE + MM_QF + (plane * MM_BN + tx) * MM_KS;
#pragma unroll
    for (int k4 = 0; k4 < MM_BK / 4; ++k4) {  // bins past K are 0: fmaf(0, 0, acc) = acc
      const float4 a0 = *reinterpret_cast<const float4*>(sq + 4 * k4);
      const float4 a1 = *reinterpret_cast<const float4*>(sq + 8 * MM_KS + 4 * k4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + 4 * k4);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + 8 * MM_KS + 4 * k4);
      const float a[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
      const float b[2][4] = {{b0.x, b0.y, b0.z, b0.w}, {b1.x, b1.y, b1.z, b1.w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (PER_K && tile * MM_BK + 4 * k4 + j == next && next < k) stash();
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(a[e / 2][j], b[e % 2][j], acc[e]);
      }
    }
    if (tile + MM_STAGES < tiles) bar_arrive(1 + MM_STAGES + s, MM_THREADS);
  }
  if (chunks > 1) {
    stash();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p[MAX_CHUNKS];
#pragma unroll
      for (int h = 0; h < MAX_CHUNKS; ++h) p[h] = h < chunks ? part[(h * 4 + e) * MM_CONS + c] : 0.f;
      acc[e] = tree_sum(p, chunks);
    }
  }
  // the imaginary plane's sums to the real one's threads: y = rn(y_real + y_imag)
  float* simag = smem;                      // stage 0 is free once every tile is summed
  bar_sync(MM_BAR_CONS, MM_CONS);
  if (plane == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) simag[(ty + 8 * (e / 2)) * MM_BN + tx + 8 * (e % 2)] = acc[e];
  }
  bar_sync(MM_BAR_CONS, MM_CONS);
  if (plane == 1) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = ty + 8 * (e / 2), col = tx + 8 * (e % 2), r = r0 + row, cc = c0 + col;
    if (r < m && cc < n) y[(size_t)r * n + cc] = __fadd_rn(acc[e], simag[row * MM_BN + col]);
  }
}

template <bool PER_K>
cudaError_t launch_mm(cudaStream_t stream, const float* qr, const float* qi, const float* icr,
                      const float* ici, float* y, int m, int k, int n, int chunks, int vec) {
  const size_t smem = sizeof(float) * (MM_STAGES * MM_STAGE +
                                       (chunks > 1 ? chunks * 4 * MM_CONS : 0));
  cudaError_t err = cudaFuncSetAttribute(mm_kernel<PER_K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + MM_BM - 1) / MM_BM, (n + MM_BN - 1) / MM_BN);
  mm_kernel<PER_K><<<grid, MM_THREADS, smem, stream>>>(qr, qi, icr, ici, y, m, k, n, chunks, vec);
  return cudaGetLastError();
}

}  // namespace

// Row 9 on n elements of four planes (n < 1: nothing to launch).  Launches
// on ``stream`` of ``device`` without synchronising and returns the first
// CUDA error.
extern "C" int jt_prod(int device, void* stream, const float* xr, const float* xi,
                       const float* gr, const float* gi, float* qr, float* qi, long long n) {
  if (n < 1) return cudaSuccess;
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
// without synchronising and returns the first CUDA error (m, k or n < 1 is
// an invalid launch).
extern "C" int jt_mm_tree(int device, void* stream, const float* qr, const float* qi,
                          const float* icr, const float* ici, float* y, int m, int k, int n,
                          int chunks) {
  return on_device(device, [&]() {
    if (chunks < 1 || chunks > MAX_CHUNKS || k % chunks || m < 1 || n < 1)
      return cudaErrorInvalidValue;
    const int vec = n % 4 == 0 && reinterpret_cast<size_t>(icr) % 16 == 0 &&
                    reinterpret_cast<size_t>(ici) % 16 == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return chunks > 1 && (k / chunks) % MM_BK
        ? launch_mm<true>(st, qr, qi, icr, ici, y, m, k, n, chunks, vec)
        : launch_mm<false>(st, qr, qi, icr, ici, y, m, k, n, chunks, vec);
  });
}
