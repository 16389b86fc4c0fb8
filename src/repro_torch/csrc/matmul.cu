// Matrix product (M,K) @ (K,N) with float32 accumulation, one kernel per
// dtype, each built for Hopper.
//
// Replaces: repro/kernels/matmul.py, `_mm_kernel` (the blocked MXU matmul that
// binds the paper's systolic GEMM, grid (M/bm, N/bn, K/bk) with K innermost and
// an f32 accumulator kept in scratch across the K steps).  On the card the
// sequential K grid dimension is a loop inside one block per (bm, bn) tile,
// fed by a ring of shared-memory stages that load while earlier ones multiply.
// The caller pads: M, N, K are multiples of bm, bn, bk.
//
// bfloat16 (`mm_bf16_wgmma`).  Bound: operations (989 TFLOP/s on the tensor
// cores).  Products are `wgmma.mma_async` m64nNk16, bf16 in, f32 accumulators
// in registers.  x (M,K) is K-major, as A wants; y (K,N) row-major enters as an
// N-major B through wgmma's transpose bit, never copied.  One producer warp
// issues TMA loads (`cp.async.bulk.tensor.2d`, swizzled as wide as a tile row
// allows, 128 bytes at bk >= 64) into a ring of at least 3 stages that complete
// on mbarriers; one or two consumer warpgroups (bm = 64 or 128) each run
// wgmma on 64 rows of the tile and hand the stage back.  Epilogue: each f32
// accumulator is rounded to bf16 once and stored.
//
// float32 (`mm_f32`).  Bound: operations (67 TFLOP/s on the CUDA cores).
// Products are full float32 fmaf, never TF32: integer-valued inputs give
// integer-exact results, which the GEMM binding relies on.  16-byte
// `cp.async.cg` copies fill a ring of 3 slabs of K (32 deep, or what bk shares
// with 32), one __syncthreads a slab, so the next slabs load while this one
// multiplies.  x is kept row-major (a copy engine cannot transpose), so a
// thread reads 4 consecutive k of one of its rows as one float4; y's rows are
// read as float4 too.  A thread's micro x micro outputs are 2x2 fragments of
// 4x4 at micro 8 (rows ty*4+i and bm/2+ty*4+i), so a warp's float4 reads of
// either operand are free of bank conflicts.
#include "hopper.cuh"

namespace {

// -- float32 on the CUDA cores -------------------------------------------------

template <int MICRO, int MIN_BLOCKS>
__global__ void __launch_bounds__(MICRO == 8 ? 256 : 1024, MIN_BLOCKS)
mm_f32(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
       int M, int N, int K, int bm, int bn, int ks) {
  constexpr int F = MICRO < 4 ? MICRO : 4;     // fragment edge
  constexpr int FR = MICRO / F;                 // fragments a dim (2 at micro 8)
  extern __shared__ __align__(16) float fsm[];
  const int lda = ks + 4;                       // +4: rows 4 apart fall 16 banks apart
  const int xs_len = bm * lda, ys_len = ks * bn;
  const int tcols = bn / MICRO;
  const int nthreads = tcols * (bm / MICRO);
  const int tid = threadIdx.x;
  const int tx = tid % tcols, ty = tid / tcols;
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int slabs = K / ks;

  auto load_slab = [&](int s) {
    if (s < slabs) {
      float* xs = fsm + (s % 3) * (xs_len + ys_len);
      float* ys = xs + xs_len;
      const int k0 = s * ks, xq = ks / 4, yq = bn / 4;
      for (int e = tid; e < bm * xq; e += nthreads) {
        const int r = e / xq, c = (e % xq) * 4;
        cp_async16(smem_u32(xs + r * lda + c), x + (size_t)(m0 + r) * K + k0 + c);
      }
      for (int e = tid; e < ks * yq; e += nthreads) {
        const int r = e / yq, c = (e % yq) * 4;
        cp_async16(smem_u32(ys + r * bn + c), y + (size_t)(k0 + r) * N + n0 + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);   // empty groups keep the count
  };

  float acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.0f;

  load_slab(0);
  load_slab(1);
  for (int s = 0; s < slabs; ++s) {
    asm volatile("cp.async.wait_group 1;\n" ::);   // this thread's copies of slab s
    __syncthreads();                                 // everyone's; slab s-1 is done with
    load_slab(s + 2);                                // into slab s-1's buffer
    const float* xs = fsm + (s % 3) * (xs_len + ys_len);
    const float* ys = xs + xs_len;
    for (int k4 = 0; k4 < ks; k4 += 4) {
      float a[MICRO][4];
#pragma unroll
      for (int fr = 0; fr < FR; ++fr)
#pragma unroll
        for (int i = 0; i < F; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + (fr * (bm / FR) + ty * F + i) * lda + k4);
          a[fr * F + i][0] = v.x; a[fr * F + i][1] = v.y;
          a[fr * F + i][2] = v.z; a[fr * F + i][3] = v.w;
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[MICRO];
        const float* yrow = ys + (k4 + q) * bn + tx * F;
#pragma unroll
        for (int fc = 0; fc < FR; ++fc) {
          if constexpr (F == 4) {
            const float4 v = *reinterpret_cast<const float4*>(yrow + fc * (bn / FR));
            b[fc * 4] = v.x; b[fc * 4 + 1] = v.y; b[fc * 4 + 2] = v.z; b[fc * 4 + 3] = v.w;
          } else {
#pragma unroll
            for (int j = 0; j < F; ++j) b[fc * F + j] = yrow[fc * (bn / FR) + j];
          }
        }
#pragma unroll
        for (int i = 0; i < MICRO; ++i)
#pragma unroll
          for (int j = 0; j < MICRO; ++j) acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int fr = 0; fr < FR; ++fr)
#pragma unroll
    for (int i = 0; i < F; ++i) {
      float* row = out + (size_t)(m0 + fr * (bm / FR) + ty * F + i) * N + n0 + tx * F;
#pragma unroll
      for (int fc = 0; fc < FR; ++fc) {
        const float* v = &acc[fr * F + i][fc * F];
        if constexpr (F == 4) {
          *reinterpret_cast<float4*>(row + fc * (bn / FR)) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < F; ++j) row[fc * (bn / FR) + j] = v[j];
        }
      }
    }
}

template <int MICRO, int MIN_BLOCKS>
int launch_f32_one(const float* x, const float* y, float* out, int M, int N, int K,
                   int bm, int bn, int ks, cudaStream_t stream) {
  auto kernel = mm_f32<MICRO, MIN_BLOCKS>;
  static bool attr_set = false;                  // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int threads = (bm / MICRO) * (bn / MICRO);
  const size_t smem = (size_t)3 * (bm * (ks + 4) + ks * bn) * sizeof(float);
  if (threads > (MICRO == 8 ? 256 : 1024) || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid(N / bn, M / bm);
  kernel<<<grid, threads, smem, stream>>>(x, y, out, M, N, K, bm, bn, ks);
  return (int)cudaGetLastError();
}

// -- bfloat16 on the tensor cores -----------------------------------------------

constexpr int MAX_STAGES = 8;

// bytes of one stage, rounded up so that every stage starts on a 1 KB
// boundary, where a 128-byte swizzle atom must start
__host__ __device__ __forceinline__ int stage_size(int bm, int bn, int bk) {
  return (bm * bk * 2 + bk * bn * 2 + 1023) / 1024 * 1024;
}

// dynamic shared memory of a launch: slack to align the ring to 1 KB, the
// ring, and the full and empty barriers
size_t bf16_smem(int bm, int bn, int bk, int stages) {
  return 1024 + (size_t)stages * stage_size(bm, bn, bk) + 2 * MAX_STAGES * 8;
}

// One block per (bm, bn) output tile: warpgroups 0..bm/64-1 consume, the last
// warpgroup produces.  Stage s holds bk/ka boxes of x (bm rows x swz_a bytes
// each, ka = swz_a/2 values of k a row) then bn/nb boxes of y (bk rows x swz_b
// bytes each, nb = swz_b/2 columns a row).  NI is the width of one wgmma; a
// tile is bn/NI of them side by side.
template <int NI>
__global__ void __launch_bounds__(384, 1)
mm_bf16_wgmma(const __grid_constant__ CUtensorMap tma_x, const __grid_constant__ CUtensorMap tma_y,
              __nv_bfloat16* __restrict__ out, int N, int K, int bm, int bn, int bk,
              int stages, int swz_a, int swz_b) {
  extern __shared__ __align__(1024) uint8_t bsm[];
  const uint32_t base = (smem_u32(bsm) + 1023u) & ~1023u;   // swizzle atoms repeat at 1 KB
  const int consumers = bm / 64;
  const int a_bytes = bm * bk * 2, stage_bytes = stage_size(bm, bn, bk);
  const int ka = swz_a / 2, nb = swz_b / 2;
  const int kblocks = K / bk;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  // after the ring: stage s is full when its loads land, empty when every
  // consumer warpgroup has finished with it
  const uint32_t full = base + stages * stage_bytes, empty = full + MAX_STAGES * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == consumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % stages;
        if (kb >= stages) mbar_wait(empty + 8 * s, ((kb / stages) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, a_bytes + bk * bn * 2);
        const uint32_t a_dst = base + s * stage_bytes, b_dst = a_dst + a_bytes;
        const int k0 = kb * bk;
        for (int b = 0; b < bk / ka; ++b)
          tma_load_2d(a_dst + b * bm * swz_a, &tma_x, k0 + b * ka, m0, bar);
        for (int j = 0; j < bn / nb; ++j)
          tma_load_2d(b_dst + j * bk * swz_b, &tma_y, n0 + j * nb, k0, bar);
      }
    }
  } else {
    // consumer warpgroup wg: rows wg*64 .. wg*64+63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int MAXC = 256 / NI;
    const int chunks = bn / NI;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int s = kb % stages;
      mbar_wait(full + 8 * s, (kb / stages) & 1);
      const uint32_t a_st = base + s * stage_bytes + wg * 64 * swz_a;
      const uint32_t b_st = base + s * stage_bytes + a_bytes;
      wgmma_fence();
      for (int kk = 0; kk < bk / 16; ++kk) {
        // A: k16 step kk lies in box kk*16/ka, 32 bytes a step into its rows
        const uint32_t a_addr = a_st + (kk * 16 / ka) * bm * swz_a + (kk * 16 % ka) * 2;
        const uint64_t da = smem_desc(a_addr, 16, 8 * swz_a, swz_a);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < chunks) {
            // B: chunk c starts NI/nb boxes in; k16 step kk is 16 rows down
            const uint32_t b_addr = b_st + c * (NI / nb) * bk * swz_b + kk * 16 * swz_b;
            wgmma_ss<NI>(d + c * (NI / 2), da, smem_desc(b_addr, bk * swz_b, 8 * swz_b, swz_b), 1);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
    }
    // epilogue: accumulator i of chunk c is row w*16 + l/4 (+8), column
    // c*NI + (i/4)*8 + (l%4)*2 (+1) of this warpgroup's 64 rows
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    const int row = m0 + wg * 64 + w * 16 + l / 4;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < chunks) {
#pragma unroll
        for (int j = 0; j < NI / 8; ++j) {
          const float* v = d + c * (NI / 2) + j * 4;
          const int col = n0 + c * NI + j * 8 + (l % 4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * N + col) =
              __floats2bfloat162_rn(v[2], v[3]);
        }
      }
    }
  }
}

template <int NI>
int launch_bf16_one(const CUtensorMap& mx, const CUtensorMap& my, __nv_bfloat16* out,
                    int M, int N, int K, int bm, int bn, int bk, int stages, int swz_a,
                    int swz_b, cudaStream_t stream) {
  auto kernel = mm_bf16_wgmma<NI>;
  static bool attr_set = false;                  // once per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const size_t smem = bf16_smem(bm, bn, bk, stages);
  dim3 grid(N / bn, M / bm);
  kernel<<<grid, (bm / 64 + 1) * 128, smem, stream>>>(mx, my, out, N, K, bm, bn, bk, stages,
                                                      swz_a, swz_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers: raw pointers to contiguous row-major arrays, the (padded) sizes,
// the tile sizes and the stream; they launch on `stream` and return
// cudaGetLastError() (cudaErrorInvalidValue for a schedule the kernel does
// not take; the Python wrapper's check_schedule refuses those first).

// float32 on the CUDA cores: `micro` is the edge of a thread's square patch of
// outputs (8, 4, 2 or 1), `ks` the depth of a slab of K.
extern "C" int launch_matmul_f32(const void* x, const void* y, void* out, int M, int N, int K,
                                 int bm, int bn, int bk, int micro, int ks, void* stream) {
  if (M % bm || N % bn || K % bk || bk % ks || ks % 4 || bn % 4 || bm % micro || bn % micro)
    return (int)cudaErrorInvalidValue;
  const float *fx = (const float*)x, *fy = (const float*)y;
  float* fo = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (micro) {
    case 8: return launch_f32_one<8, 2>(fx, fy, fo, M, N, K, bm, bn, ks, st);
    case 4: return launch_f32_one<4, 1>(fx, fy, fo, M, N, K, bm, bn, ks, st);
    case 2: return launch_f32_one<2, 1>(fx, fy, fo, M, N, K, bm, bn, ks, st);
    case 1: return launch_f32_one<1, 1>(fx, fy, fo, M, N, K, bm, bn, ks, st);
  }
  return (int)cudaErrorInvalidValue;
}

// bfloat16 on the tensor cores: `stages` shared-memory stages of (bm x bk of x,
// bk x bn of y); `ni` the width of one wgmma (16, 32, 64, 128 or 256, dividing bn).
extern "C" int launch_matmul_bf16_wgmma(const void* x, const void* y, void* out, int M, int N,
                                        int K, int bm, int bn, int bk, int stages, int ni,
                                        void* stream) {
  if (M % bm || N % bn || K % bk || (bm != 64 && bm != 128) || bn % ni || bn > 256 ||
      bk % 16 || bk > 256 || stages < 3 || stages > MAX_STAGES ||
      bf16_smem(bm, bn, bk, stages) > SMEM_LIMIT ||
      ((uintptr_t)x | (uintptr_t)y) % 16)
    return (int)cudaErrorInvalidValue;
  const int swz_a = swizzle_for(bk), swz_b = swizzle_for(ni);
  CUtensorMap mx, my;
  if (!make_map(&mx, x, M, K, swz_a / 2, bm, swz_a) ||
      !make_map(&my, y, K, N, swz_b / 2, bk, swz_b))
    return (int)cudaErrorInvalidValue;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (ni) {
    case 16: return launch_bf16_one<16>(mx, my, o, M, N, K, bm, bn, bk, stages, swz_a, swz_b, st);
    case 32: return launch_bf16_one<32>(mx, my, o, M, N, K, bm, bn, bk, stages, swz_a, swz_b, st);
    case 64: return launch_bf16_one<64>(mx, my, o, M, N, K, bm, bn, bk, stages, swz_a, swz_b, st);
    case 128: return launch_bf16_one<128>(mx, my, o, M, N, K, bm, bn, bk, stages, swz_a, swz_b, st);
    case 256: return launch_bf16_one<256>(mx, my, o, M, N, K, bm, bn, bk, stages, swz_a, swz_b, st);
  }
  return (int)cudaErrorInvalidValue;
}
