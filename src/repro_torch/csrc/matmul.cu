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
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SMEM_LIMIT = 232448;     // shared memory one block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- float32 on the CUDA cores -------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
}

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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A stage that never
// completes (a lost load) traps after about 20 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's layout code for a swizzle of `bytes` (a row of the swizzle atom)
__device__ __forceinline__ uint64_t layout_code(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout_code(swizzle_bytes) << 62);
}

template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

// m64nNk16, f32 += bf16 * bf16; A K-major (transpose 0), B N-major (transpose 1)
template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<256>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
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
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int kk = 0; kk < bk / 16; ++kk) {
        // A: k16 step kk lies in box kk*16/ka, 32 bytes a step into its rows
        const uint32_t a_addr = a_st + (kk * 16 / ka) * bm * swz_a + (kk * 16 % ka) * 2;
        const uint64_t da = smem_desc(a_addr, 16, 8 * swz_a, swz_a);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < chunks) {
            // B: chunk c starts NI/nb boxes in; k16 step kk is 16 rows down
            const uint32_t b_addr = b_st + c * (NI / nb) * bk * swz_b + kk * 16 * swz_b;
            wgmma<NI>(d + c * (NI / 2), da, smem_desc(b_addr, bk * swz_b, 8 * swz_b, swz_b));
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the library is not linked against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_mode(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
       : bytes == 64  ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// widest swizzle (128, 64 or 32 bytes) that divides a row of `elems` bf16
int swizzle_for(int elems) {
  const int bytes = elems * 2;
  return bytes % 128 == 0 ? 128 : bytes % 64 == 0 ? 64 : 32;
}

// A row-major (rows, cols) bf16 matrix cut in boxes of box_cols x box_rows.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols,
              int box_rows, int swz) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(swz),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
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
