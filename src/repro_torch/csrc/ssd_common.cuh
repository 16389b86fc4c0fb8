// The pieces shared by the SSD scan's forward (ssd_scan.cu, K5) and its
// backward (ssd_scan_bwd.cu, S3): tile loads by cp.async with zero fill, the
// in-chunk cumulative sum of the decay logs in double, products in 3xTF32 on
// mma.sync (mma3), and ssd_chunk_state, which forms one chunk's (N, P) sum of
// weighted outer products for both: the forward's state increments and the
// backward's increments of the states' gradients.  `_build.csrc_source`
// splices it into both sources.
#pragma once
#include "hopper.cuh"

namespace {

constexpr int T = 64;              // rows and columns of a tile
constexpr int SA = T + 4;          // row stride of a tile read as A[m][k] or as B[n][k]
constexpr int SB = T + 8;          // row stride of a tile read as B[k][n]
constexpr int KS = 32;             // positions a step of ssd_chunk_state
constexpr int MAX_N = 128;         // state rows: 8 warps of 16 in ssd_chunk_state
constexpr int SN = MAX_N + 8;      // row stride of ssd_chunk_state's B tile, [s][n]
constexpr int THREADS = 128;       // ssd_chunk_cb and ssd_chunk_scan: 4 warps of 16 rows
constexpr int STATE_THREADS = 256;
constexpr int PASS_THREADS = 256;

struct Str3 {
  long long b, h, s;               // (lane, head, position), in elements
};
struct Str2 {
  long long b, s;                  // (lane, position), in elements
};

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// -- loads --------------------------------------------------------------------------

// cp.async of `bytes` (<= the size) from src, the rest of the 16 (or 4) bytes zero
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(dst), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A ROWS x COLS tile of floats (COLS a multiple of 4) from `src` (row stride
// `ld`) into shared memory at `dst` (row stride `sd`), rows at or past `rv`
// and columns at or past `cv` as zeros. `vec`: every row of src starts on 16
// bytes, so the copy goes 16 bytes at a time; else 4. Row 0 and column 0 of
// src exist, so a copy that reads nothing points there.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(float* dst, int sd, const float* src, long long ld,
                                          int rv, int cv, bool vec) {
  if (vec) {
    constexpr int PER = COLS / 4;
    static_assert(ROWS * PER % NT == 0, "whole rounds of the block");
#pragma unroll
    for (int i = 0; i < ROWS * PER / NT; ++i) {
      const int e = threadIdx.x + i * NT, r = e / PER, c = (e % PER) * 4;
      const int bytes = r < rv ? 4 * max(0, min(4, cv - c)) : 0;
      cp_async16_zfill(smem_u32(dst + r * sd + c), bytes ? src + r * ld + c : src, bytes);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS;
      const int bytes = r < rv && c < cv ? 4 : 0;
      cp_async4_zfill(smem_u32(dst + r * sd + c), bytes ? src + r * ld + c : src, bytes);
    }
  }
}

// cum[i] for i < n: dA summed over positions 0..i of the chunk in double, the
// positions at or past Qv (past S) counting 0. The block loads dA into cum
// (strided loads, all in flight at once), then warp 0 sums it in place.
__device__ void chunk_cumsum(double* cum, const float* dp, long long ds, int Qv, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cum[i] = i < Qv ? (double)dp[(long long)i * ds] : 0.0;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  double carry = 0.0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    double v = i < n ? cum[i] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (i < n) cum[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// -- 3xTF32 on mma.sync -------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives for a finite x, in two integer instructions
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as hi + lo, both TF32 (x - hi is exact in f32)
__device__ __forceinline__ uint2 split(float x) {
  const uint32_t hi = tf32(x);
  return make_uint2(hi, tf32(x - __uint_as_float(hi)));
}


// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 in, f32 accumulator
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The three TF32 passes of A (16 x K) B (K x 8 NJ) for a warp's 16 rows x 8 NJ
// columns (NJ m16n8 tiles; element e of tile j at row g + 8 (e / 2), column
// 8 j + 2 t + e % 2, g = lane / 4, t = lane % 4): big += A.hi B.hi and
// small += A.lo B.hi + A.hi B.lo. afetch(half, k): A at row g + 8 half,
// column k; bfetch(k, j): B at row k, column 8 j + g. UNROLL steps of 8 k are
// unrolled (by default all of them up to K 32, else none).
template <int K, int NJ, int UNROLL = (K <= 32 ? K / 8 : 1), typename FA, typename FB>
__device__ __forceinline__ void mma3_passes(float (&big)[NJ][4], float (&small)[NJ][4],
                                            FA afetch, FB bfetch) {
  const int t = threadIdx.x & 3;
#pragma unroll (UNROLL)
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {                  // rows g, g + 8; columns t, t + 4
      const uint2 a = split(afetch(i & 1, k0 + t + 4 * (i >> 1)));
      ah[i] = a.x;
      al[i] = a.y;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const uint2 b0 = split(bfetch(k0 + t, j)), b1 = split(bfetch(k0 + t + 4, j));
      mma_tf32(small[j], al, b0.x, b1.x);
      mma_tf32(small[j], ah, b0.y, b1.y);
      mma_tf32(big[j], ah, b0.x, b1.x);
    }
  }
}

// total += A B in 3xTF32, as mma3_passes lays them out. The tensor cores round
// each mma's sum toward zero against its largest addend, so every mma into a
// running sum biases it by up to an ulp of that sum: the step's hi.hi and its
// small lo.hi + hi.lo go into fresh accumulators of their own, which are then
// added to `total` in f32, to nearest, rows g and g + 8 weighted by r0 and r1.
template <int K, int NJ, int UNROLL = (K <= 32 ? K / 8 : 1), typename FA, typename FB>
__device__ __forceinline__ void mma3(float (&total)[NJ][4], FA afetch, FB bfetch,
                                     float r0 = 1.f, float r1 = 1.f) {
  float big[NJ][4], small[NJ][4];
  zero(big);
  zero(small);
  mma3_passes<K, NJ, UNROLL>(big, small, afetch, bfetch);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) total[j][e] = fmaf(e < 2 ? r0 : r1, big[j][e] + small[j][e],
                                                   total[j][e]);
}

// -- each chunk's (N, P) sum of weighted outer products -------------------------------

__host__ __device__ inline size_t state_smem(int QP) {
  return (size_t)2 * (KS * SN + KS * SB) * sizeof(float) +
         (size_t)QP * (sizeof(double) + sizeof(float));
}

// One block per (chunk, tile of P, head, lane) forms sum_s u_s[n] w_s v_s[p]
// over the chunk's positions, u (B, S, N) shared by the heads and v
// (B, H, S, P) per head, into slot `slot` of a (B, H, nc, N, PS) scratch.
// BWD false (K5's stage 2): the chunks before the last, u = B, v = x,
// w_s = exp(last - cum_s), into slot c + 1, and exp(last) into slot c + 1 of
// the decays: the state increment dH_c. BWD true (S3): the chunks after the
// first, the last perhaps ragged, u = C, v = dy, w_s = exp(cum_s), into slot
// c: the increment (C o exp(cum))^T dy of the gradient of h_c.
template <bool BWD>
__global__ void __launch_bounds__(STATE_THREADS, 1)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dA,
                const float* __restrict__ Bm, float* __restrict__ states,
                float* __restrict__ decays, int S, int P, int N, int Q, int QP, int PS, int nc,
                Str3 xs, Str3 das, Str2 bs, int x_vec, int bc_vec) {
  extern __shared__ __align__(16) float smem[];   // 2 stages of B [s][n] then x [s][p]
  double* cum = reinterpret_cast<double*>(smem + 2 * (KS * SN + KS * SB));
  float* wv = reinterpret_cast<float*>(cum + QP);  // w_s
  const int c = blockIdx.x % (nc - 1) + BWD, pt = blockIdx.x / (nc - 1);
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int c0 = c * Q, Qv = BWD ? min(Q, S - c0) : Q;   // the forward's: Q positions
  const int PT = min(T, P - pt * T);
  const float* xp = x + b * xs.b + h * xs.h + (long long)c0 * xs.s + pt * T;
  const float* bp = Bm + b * bs.b + (long long)c0 * bs.s;
  const int steps = (Q + KS - 1) / KS;
  auto load = [&](int j) {
    float* at = smem + (j & 1) * (KS * SN + KS * SB);
    load_tile<KS, MAX_N, STATE_THREADS>(at, SN, bp + (long long)j * KS * bs.s, bs.s,
                                        Qv - j * KS, N, bc_vec);
    load_tile<KS, T, STATE_THREADS>(at + KS * SN, SB, xp + (long long)j * KS * xs.s, xs.s,
                                    Qv - j * KS, PT, x_vec);
  };
  load(0);
  cp_commit();
  chunk_cumsum(cum, dA + b * das.b + h * das.h + (long long)c0 * das.s, das.s, Qv, Q);
  __syncthreads();
  const double last = cum[Q - 1];
  for (int s = threadIdx.x; s < steps * KS; s += STATE_THREADS)   // 0 past the chunk
    wv[s] = s < Qv ? (float)exp(BWD ? cum[s] : last - cum[s]) : 0.f;
  const size_t bh = (size_t)b * H + h;
  if (!BWD && pt == 0 && threadIdx.x == 0) decays[bh * nc + c + 1] = (float)exp(last);

  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool active = 16 * w < N;                  // this warp's 16 state rows exist
  float acc[8][4];
  zero(acc);
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // tile j is in (and wv); step j - 1 is done
    if (j + 1 < steps) load(j + 1);
    cp_commit();
    if (active) {
      const float* at = smem + (j & 1) * (KS * SN + KS * SB) + 16 * w;
      const float* bt = smem + (j & 1) * (KS * SN + KS * SB) + KS * SN;
      const float* ws = wv + j * KS;
      // A = (u o w)^T: row n of the state, column s of the step
      mma3<KS, 8>(acc, [&](int half, int k) { return at[k * SN + g + 8 * half] * ws[k]; },
               [&](int k, int jj) { return bt[k * SB + 8 * jj + g]; });
    }
  }
  float* out = states + ((bh * nc + c + !BWD) * N) * PS;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = 16 * w + g + 8 * half;
    if (n >= N) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = pt * T + 8 * jj + 2 * t;       // even, and PS a multiple of 4
      if (p < PS)
        *reinterpret_cast<float2*>(out + (size_t)n * PS + p) =
            make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
    }
  }
}

// -- host ----------------------------------------------------------------------------

bool rows_of_16_bytes(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 | s1 | s2) % 4 == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;       // above 48 KB a kernel must ask
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}
}  // namespace
