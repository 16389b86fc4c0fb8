// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t, from h = 0, in
// float32 — the scan of Griffin's / RecurrentGemma's recurrent block.
//
// Replaces: repro/kernels/rglru_scan.py:56, the `pallas_call` of
// `_rglru_kernel` (grid (B, D/bd, S/bs), the sequence dimension innermost and
// sequential on the TPU, the carry (1, bd) in VMEM scratch, and inside a block
// a log2(bs)-step doubling on (a, b) pairs).
//
// Bound on this card: bytes. Each step reads a and b and writes h, 12 bytes,
// for two floating-point operations. At the RecurrentGemma prefill (B 2,
// S 4096, D 4096) that is 403 MB, 0.120 ms at 3.35 TB/s.
//
// Design: one block of 8 warps per (32 channels, lane); a warp's 32 threads
// take neighbouring channels, so every load and store of a step is one
// 128-byte line. The block walks the sequence in rounds of 8 x 32 steps: each
// warp loads its 32 steps into registers (all 64 loads in flight at once),
// composes them into one affine map h -> A h + B, and publishes (A, B) in
// shared memory; each warp then applies the maps of the warps before it to
// the round's incoming carry, runs its 32 steps from there and stores h; the
// last warp's final h carries into the next round. This is the TPU kernel's
// blocked scan with the combine (a1 a2, a2 b1 + b2) across warps and a plain
// loop inside a warp. At (2, 4096, 4096) it gives 256 blocks of 256 threads,
// where one thread per channel would give 8,192 threads in all. Channels and
// steps past D and S are masked (a = 1, b = 0, nothing stored).
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int STEPS = 32;          // steps per warp per round
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ h,
             int S, int D, long long a_sb, long long a_ss, long long b_sb, long long b_ss,
             long long h_sb, long long h_ss) {
  __shared__ float seg_a[WARPS][32], seg_b[WARPS][32], carry[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = blockIdx.x * 32 + lane, lb = blockIdx.y;
  const bool on = d < D;
  const float* ap = a + lb * a_sb + d;
  const float* bp = b + lb * b_sb + d;
  float* hp = h + lb * h_sb + d;
  if (warp == 0) carry[lane] = 0.f;

  for (int t0 = 0; t0 < S; t0 += WARPS * STEPS) {
    const int s0 = t0 + warp * STEPS;
    float av[STEPS], bv[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const bool ok = on && s0 + i < S;
      av[i] = ok ? ap[(s0 + i) * a_ss] : 1.f;
      bv[i] = ok ? bp[(s0 + i) * b_ss] : 0.f;
    }
    float A = 1.f, Bs = 0.f;                      // this warp's steps as h -> A h + Bs
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      Bs = av[i] * Bs + bv[i];
      A *= av[i];
    }
    seg_a[warp][lane] = A;
    seg_b[warp][lane] = Bs;
    __syncthreads();                              // also orders last round's carry write
    float hv = carry[lane];
    for (int w = 0; w < warp; ++w) hv = seg_a[w][lane] * hv + seg_b[w][lane];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      hv = av[i] * hv + bv[i];
      if (on && s0 + i < S) hp[(s0 + i) * h_ss] = hv;
    }
    __syncthreads();                              // every warp has read carry and the maps
    if (warp == WARPS - 1) carry[lane] = hv;
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ da, float* __restrict__ db,
                 int S, int D, long long a_sb,
                 long long a_ss, long long h_sb, long long h_ss, long long g_sb, long long g_ss,
                 long long da_sb, long long da_ss, long long db_sb, long long db_ss) {
  __shared__ float seg_a[WARPS][32], seg_b[WARPS][32], carry[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = blockIdx.x * 32 + lane, lb = blockIdx.y;
  const bool on = d < D;
  const float* ap = a + lb * a_sb + d;
  const float* hp = h + lb * h_sb + d;
  const float* gp = dh + lb * g_sb + d;
  float* dap = da + lb * da_sb + d;
  float* dbp = db + lb * db_sb + d;
  if (warp == 0) carry[lane] = 0.f;

  for (int t1 = S; t1 > 0; t1 -= WARPS * STEPS) {
    const int s1 = t1 - warp * STEPS;             // this warp's steps: s1 - 1 down to s1 - 32
    float av[STEPS], bv[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int t = s1 - 1 - i;
      const bool ok = on && t >= 0;
      av[i] = ok && t + 1 < S ? ap[(t + 1) * a_ss] : (ok ? 0.f : 1.f);   // a_{t+1}; a_S = 0
      bv[i] = ok ? gp[t * g_ss] : 0.f;
    }
    float A = 1.f, Bs = 0.f;                      // this warp's steps as g -> A g + Bs
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      Bs = av[i] * Bs + bv[i];
      A *= av[i];
    }
    seg_a[warp][lane] = A;
    seg_b[warp][lane] = Bs;
    __syncthreads();                              // also orders last round's carry write
    float gv = carry[lane];
    for (int w = 0; w < warp; ++w) gv = seg_a[w][lane] * gv + seg_b[w][lane];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      const int t = s1 - 1 - i;
      gv = av[i] * gv + bv[i];
      if (on && t >= 0) {
        dbp[t * db_ss] = gv;
        dap[t * da_ss] = t > 0 ? gv * hp[(t - 1) * h_ss] : 0.f;
      }
    }
    __syncthreads();                              // every warp has read carry and the maps
    if (warp == WARPS - 1) carry[lane] = gv;
  }
}

}  // namespace

// Launcher: a, b and h (B,S,D), each given by its pointer and its strides over
// (lane, position) — six values in `strides`, a's, b's, h's — with D
// contiguous. Launches on `stream` and returns cudaGetLastError().
extern "C" int launch_rglru_scan_f32(const float* a, const float* b, float* h, int Bn, int S,
                                     int D, const long long* st, void* stream) {
  if (Bn <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((D + 31) / 32, Bn);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, h, S, D, st[0], st[1], st[2],
                                                           st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}


// Launcher of the backward: a, h (the forward's output), dh, da and db (B,S,D),
// each given by its pointer and its strides over (lane, position) — ten
// values in `strides`, a's, h's, dh's, da's, db's — with D contiguous.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int launch_rglru_scan_bwd_f32(const float* a, const float* h, const float* dh,
                                         float* da, float* db, int Bn, int S, int D,
                                         const long long* st, void* stream) {
  if (Bn <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((D + 31) / 32, Bn);
  rglru_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, h, dh, da, db, S, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9]);
  return (int)cudaGetLastError();
}
