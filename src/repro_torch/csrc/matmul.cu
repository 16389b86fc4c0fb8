// Tiled matrix product (M,K) @ (K,N) for float and bfloat16 inputs.
//
// Replaces: repro/kernels/matmul.py, `_mm_kernel` (the blocked MXU matmul that
// binds the paper's systolic GEMM, grid (M/bm, N/bn, K/bk) with K innermost and
// an f32 accumulator kept in scratch across the K steps).
//
// Bound on this card: operations. Each input element is reused bm or bn times
// from shared memory, so at the tile sizes used the product is limited by the
// FP32 FMA rate of the CUDA cores. Products are full float32 (no TF32, no
// tensor cores): integer-valued inputs must give integer-exact results.
//
// Design: one block per (bm, bn) output tile. The TPU's sequential K grid
// dimension is a loop inside the block: each step stages a (bm, bk) tile of x
// (transposed, so a thread's rows are contiguous) and a (bk, bn) tile of y in
// shared memory as float, synchronises, and every thread accumulates a TM x TN
// micro-tile in registers. The micro-tile is strided over the block (row
// ty + i*bm/TM, column tx + j*bn/TN), which keeps shared-memory reads free of
// bank conflicts and global stores coalesced. One cast and store at the end.
// The caller pads: M, N, K are multiples of bm, bn, bk.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, int TM, int TN, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
mm_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
          int M, int N, int K, int bm, int bn, int bk) {
  extern __shared__ float smem[];
  const int ldx = bm + 1;            // +1: staging stores of x spread over banks
  float* xs = smem;                  // (bk, bm) transposed tile of x, stride ldx
  float* ys = smem + bk * ldx;       // (bk, bn) tile of y

  const int tcols = bn / TN;         // threads along the tile's columns
  const int trows = bm / TM;
  const int nthreads = tcols * trows;
  const int tid = threadIdx.x;
  const int tx = tid % tcols;
  const int ty = tid / tcols;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int e = tid; e < bm * bk; e += nthreads) {
      const int r = e / bk, kk = e % bk;
      xs[kk * ldx + r] = to_float(x[(size_t)(m0 + r) * K + (k0 + kk)]);
    }
    for (int e = tid; e < bk * bn; e += nthreads) {
      const int kk = e / bn, c = e % bn;
      ys[kk * bn + c] = to_float(y[(size_t)(k0 + kk) * N + (n0 + c)]);
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk * ldx + ty + i * trows];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk * bn + tx + j * tcols];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      from_float(acc[i][j],
                 &out[(size_t)(m0 + ty + i * trows) * N + (n0 + tx + j * tcols)]);
}

template <typename T, int MICRO, int MAX_THREADS>
int launch_one(const void* x, const void* y, void* out, int M, int N, int K,
               int bm, int bn, int bk, cudaStream_t stream) {
  auto kernel = mm_kernel<T, MICRO, MICRO, MAX_THREADS>;
  const int threads = (bm / MICRO) * (bn / MICRO);
  const size_t smem = (size_t)(bk * (bm + 1) + bk * bn) * sizeof(float);
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(N / bn, M / bm);
  kernel<<<grid, threads, smem, stream>>>((const T*)x, (const T*)y, (T*)out,
                                          M, N, K, bm, bn, bk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           int bm, int bn, int bk, int micro, cudaStream_t stream) {
  if (M % bm || N % bn || K % bk || bm % micro || bn % micro)
    return (int)cudaErrorInvalidValue;
  switch (micro) {
    case 8: return launch_one<T, 8, 256>(x, y, out, M, N, K, bm, bn, bk, stream);
    case 4: return launch_one<T, 4, 1024>(x, y, out, M, N, K, bm, bn, bk, stream);
    case 2: return launch_one<T, 2, 1024>(x, y, out, M, N, K, bm, bn, bk, stream);
    case 1: return launch_one<T, 1, 1024>(x, y, out, M, N, K, bm, bn, bk, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: raw pointers to contiguous row-major arrays, the (padded) sizes,
// the tile sizes, the micro-tile edge (8, 4, 2 or 1) and the stream. They
// launch on `stream` and return cudaGetLastError().
extern "C" int launch_matmul_f32(const void* x, const void* y, void* out, int M, int N,
                                 int K, int bm, int bn, int bk, int micro, void* stream) {
  return launch<float>(x, y, out, M, N, K, bm, bn, bk, micro, (cudaStream_t)stream);
}

extern "C" int launch_matmul_bf16(const void* x, const void* y, void* out, int M, int N,
                                  int K, int bm, int bn, int bk, int micro, void* stream) {
  return launch<__nv_bfloat16>(x, y, out, M, N, K, bm, bn, bk, micro, (cudaStream_t)stream);
}
