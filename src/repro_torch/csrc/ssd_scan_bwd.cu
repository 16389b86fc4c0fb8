// The backward of the Mamba-2 SSD chunked scan (S3) in float32, chunk-parallel,
// its products on the tensor cores in 3xTF32: the gradients of K5's inputs x,
// dA, B and C from the gradient dy of its output.
//
// Replaces: no TPU kernel. The reference trains through XLA's autodiff of its
// jnp SSD core, src/repro/models/ssd.py:80 (`ssd_core_chunked` under
// `jax.value_and_grad`, src/repro/train/steps.py:104); no Pallas kernel of
// the reference has a VJP.
//
// Per chunk c of Q positions and head h, with cum = cumsum(dA) inside the
// chunk, last its last position, w_s = exp(last - cum_s), h_c the state
// entering the chunk (K5's `states`) and G_c the gradient of h_c:
//   G_c = (C o exp(cum))^T dy + exp(last) G_{c+1}, G_nc = 0
//   dx_s = sum_{t >= s} (C_t . B_s) exp(cum_t - cum_s) dy_t + w_s B_s^T G_{c+1}
//   dB_s = sum_h [ sum_{t >= s} exp(cum_t - cum_s) (dy_t . x_s) C_t + w_s G_{c+1} x_s ]
//   dC_t = sum_h [ sum_{s <= t} exp(cum_t - cum_s) (dy_t . x_s) B_s + exp(cum_t) h_c dy_t ]
//   ddA_t = sum over t' >= t, to the end of the sequence, of dy_t'.y_t' - dx_t'.x_t'
// The last line is the step recurrence's ddA_t = exp(dA_t) <dh_t, h_{t-1}>
// summed by parts: <dh_t, h_t> = dy_t.y_t + <dh_{t+1}, h_{t+1}> - dx_{t+1}.x_{t+1}
// and h_t - B_t x_t^T = exp(dA_t) h_{t-1}, so it needs only K5's y and dx.
//
// B and C are shared by the heads ((B, S, N)), so the intra-chunk halves of dB
// and dC are one product each after a sum over the heads, exactly:
//   W[t][s] = sum_h (dy_{h,t} . x_{h,s}) exp(cum_{h,t} - cum_{h,s}), t >= s (else 0)
//   dC_intra = W B,  dB_intra = W^T C
// and the inter-chunk halves are one product each over K = H P, the pairs
// (h, p) contiguous per position in the model's (B, S, H, P) layout:
//   dB_inter[s] = sum_(h,p) (w_{h,s} x_{h,s,p}) G_{h,c+1}[:, p]
//   dC_inter[t] = sum_(h,p) (exp(cum_{h,t}) dy_{h,t,p}) h_{h,c}[:, p]
// (tests/test_torch_scan_bwd.py holds these formulas to the step-by-step
// backward in float64, and emulates them in 3xTF32.)
//
// Design: six launches on the caller's stream, each over blocks that run in
// any order. The forward's scratch is kept for them: C B^T (B, nc, QP, QP),
// the states h_c (B, H, nc, N, PS) and the chunks' decays exp(last).
//   1. ssd_chunk_state<true> (ssd_common.cuh, K5's stage 2 with C o exp(cum)
//      and dy for B o w and x): dG_c = (C o exp(cum))^T dy into slot c of a
//      (B, H, nc, N, PS) scratch, for the chunks after the first.
//   2. ssd_bwd_state_pass, K5's stage 3 in reverse: G_c = dG_c + exp(last_c)
//      G_{c+1}, element-wise, over slot c.
//   3. ssd_bwd_dx, one block per (head, tile of P, 64-row source tile,
//      chunk; lane): the transpose of K5's stage 4, C B^T's tiles read
//      transposed, target tiles t >= s, then B_s G_{c+1} weighted by w_s. Its
//      epilogue writes r_s = dy_s.y_s - dx_s.x_s in double, one partial per
//      tile of P, into a (B, H, nP, S) scratch: dy.y at the first step, from
//      the ring's dy tile and a tile of y loaded with it, dx.x from the
//      registers and a tile of x. The blocks of the first tiles write the
//      chunk's cum into a (B, H, nc, QP) double scratch.
//   4. ssd_bwd_w, one block per (target tile t, source tile s <= t, chunk;
//      lane), three an SM: W's tile, the heads in order in a loop, each
//      head's E = dy x^T over P on mma.sync, weighted by exp(cum_t - cum_s)
//      where t >= s and added in f32, into a (B, nc, QP, QP) scratch laid out
//      as C B^T.
//   5. ssd_bwd_dbc, one block per (dB or dC, 64-row tile, tile of N, chunk;
//      lane): W^T C over the target tiles (or W B over the source tiles) on
//      mma.sync, then the long product over (h, p) on wgmma, each head's
//      64-deep slice into fresh accumulators weighted by its w_s (or
//      exp(cum_t)) and added in head order; straight into dB (or dC).
//   6. ssd_bwd_ddA, one block per (head, lane): r's partials summed in tile
//      order, then summed from the end of the sequence in double.
// A call of one chunk skips stages 1 and 2, of two chunks stage 2. Stages 3,
// 4 and 5 load through cp.async, the next step's tiles in flight while this
// step's are multiplied (a two-stage ring in 3 and 4; in 5 one plain stage
// beside the split tiles that wgmma reads). No float atomics: two runs give
// the same bits.
//
// Numerics are K5's: cum and every difference of it in double before its exp,
// exp only where t >= s (the exponent is then at most 0), each product in
// three TF32 passes whose sums are kept apart (mma3). A ragged tail, N and P
// off the tiles are masked by zero-filled loads and stores that skip them.
//
// Bound on this card: operations, products at 3xTF32's 494.7 / 3 TFLOP/s. At
// Mamba-2's training shape (B 4, S 2048, H 48, P 64, N 128, Q 256) the
// products of the formulas above over the causal pairs, the N products after
// the head sum (chip_smoke.py's `ssd_bwd_flops`: 36.0 GFLOP, 0.218 ms),
// against x, dA, B, C, y, dy and the kept scratch read once and dx, ddA, dB,
// dC written once (0.144 ms). What is left: the diagonal tiles' upper halves
// are multiplied and dropped; on mma.sync each warp splits the shared B
// operand into its TF32 halves again; stage 4 on wgmma measured slower than on
// mma.sync (its split pass, and two blocks an SM for its few blocks), and
// stage 5's split pass is not overlapped with its products.
#include "ssd_common.cuh"

namespace {

constexpr int DDA_THREADS = 256;   // ssd_bwd_ddA: positions DDA_PER a thread, a round
constexpr int DDA_PER = 8;

// n doubles (n even, src and dst on 16 bytes) into shared memory, two a
// thread by the threads from `from` on
__device__ __forceinline__ void load_doubles(double* dst, const double* src, int n, int from) {
  const int i = threadIdx.x - from;
  if (i >= 0 && 2 * i < n) cp_async16_zfill(smem_u32(dst + 2 * i), src + 2 * i, 16);
}

// -- 3xTF32 on wgmma ----------------------------------------------------------------

// A 64 x 64 tile of TF32 values, K-major with the 128-byte swizzle, as wgmma
// reads it: two boxes of 64 rows x 32 k (8 KB each); in a box, row m's 16-byte
// chunk c (k 4 c .. 4 c + 3) sits at m * 128 + (c ^ (m % 8)) * 16. Its base is
// on 1 KB, where the swizzle's atoms repeat.
constexpr int KTILE = 2 * T * 128;                 // bytes

// The 64 x 64 tile of floats at src (row stride ld floats, rows on 16 bytes;
// rows m, columns k) split into its hi and lo TF32 halves (split()), written
// K-major into the tiles at hi and lo. By the whole block; the caller fences
// (fence_async_smem) and syncs before wgmma reads them.
__device__ __forceinline__ void split_kmajor(const float* src, int ld, uint32_t hi, uint32_t lo) {
  for (int i = threadIdx.x; i < T * 16; i += blockDim.x) {
    const int m = i / 16, c = i % 16;
    const float4 v = *reinterpret_cast<const float4*>(src + m * ld + 4 * c);
    const uint2 a = split(v.x), b = split(v.y), d = split(v.z), e = split(v.w);
    const uint32_t off = (c / 8) * (T * 128) + m * 128 + (((c % 8) ^ (m & 7)) * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" :: "r"(hi + off), "r"(a.x),
                 "r"(b.x), "r"(d.x), "r"(e.x) : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" :: "r"(lo + off), "r"(a.y),
                 "r"(b.y), "r"(d.y), "r"(e.y) : "memory");
  }
}

// this thread's writes to shared memory, seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (m64 x n64, f32; the layout of mma3's accumulators, 8 n8 tiles) += A (m64 x
// k8) B (k8 x n64), TF32 in, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// The three passes of a 64 x 64 x 64 product on wgmma, A and B split into
// K-major hi and lo tiles (split_kmajor): big += A.hi B.hi, small += A.lo B.hi
// + A.hi B.lo, as mma3_passes. Issued and waited for by the warpgroup.
__device__ __forceinline__ void wgmma3_passes(float (&big)[8][4], float (&small)[8][4],
                                              uint32_t ahi, uint32_t alo, uint32_t bhi,
                                              uint32_t blo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T / 8; ++kk) {             // k8 step kk: box kk / 4, 32 bytes a step
    const uint32_t off = (kk / 4) * (T * 128) + (kk % 4) * 32;
    const uint64_t dah = smem_desc(ahi + off, 16, 1024, 128);
    const uint64_t dal = smem_desc(alo + off, 16, 1024, 128);
    const uint64_t dbh = smem_desc(bhi + off, 16, 1024, 128);
    const uint64_t dbl = smem_desc(blo + off, 16, 1024, 128);
    wgmma_tf32(small, dal, dbh);
    wgmma_tf32(small, dah, dbl);
    wgmma_tf32(big, dah, dbh);
  }
  wgmma_commit();
  wgmma_wait_all();
}

// -- 2. the gradients of the states entering each chunk ----------------------------------

// slot c of gst holds dG_c (c >= 1); it ends as G_c. exp(last_c) is slot c + 1
// of the forward's decays.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_state_pass(float* __restrict__ gst, const float* __restrict__ decays, int nc, int NPS) {
  const int e = (blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  if (e >= NPS) return;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  float* base = gst + bh * nc * NPS + e;
  const float* dec = decays + bh * nc;
  float4 gv = *reinterpret_cast<const float4*>(base + (size_t)(nc - 1) * NPS);
  for (int c = nc - 2; c >= 1; --c) {
    const float4 d = *reinterpret_cast<const float4*>(base + (size_t)c * NPS);
    const float a = dec[c + 1];
    gv = make_float4(fmaf(a, gv.x, d.x), fmaf(a, gv.y, d.y), fmaf(a, gv.z, d.z),
                     fmaf(a, gv.w, d.w));
    *reinterpret_cast<float4*>(base + (size_t)c * NPS) = gv;
  }
}

// -- 3. dx, with cum and r = dy.y - dx.x ---------------------------------------------------

__host__ __device__ inline size_t dx_smem(int QP) {
  return (size_t)2 * 2 * T * SB * sizeof(float) + (size_t)2 * T * SA * sizeof(float) +
         (size_t)QP * sizeof(double);
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_dx(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ dy, const float* __restrict__ dA,
           const float* __restrict__ Bm, const float* __restrict__ cb,
           const float* __restrict__ gst, float* __restrict__ dx, double* __restrict__ cumd,
           double* __restrict__ rpart, int S, int H, int P, int N, int Q, int QP, int PS,
           int nc, Str3 xs, Str3 ys, Str3 gs, Str3 das, Str2 bs, Str3 dxs, int x_vec, int y_vec,
           int dy_vec, int bc_vec, int dx_vec) {
  extern __shared__ __align__(16) float smem[];   // 2 stages of A then B, T x SB each
  float* xt = smem + 2 * 2 * T * SB;               // x's and y's rows s, [s][p], for r
  float* yt = xt + T * SA;
  double* cum = reinterpret_cast<double*>(yt + T * SA);
  const int nP = (P + T - 1) / T, ntq = QP / T;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int pt = idx % nP;
  idx /= nP;
  const int st = idx % ntq, c = idx / ntq, b = blockIdx.y;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  if (st * T >= Qv) return;                        // a source tile past the end of the last chunk
  const int PT = min(T, P - pt * T);
  const int n_tgt = (Qv - 1) / T - st + 1;         // the target tiles st .. (Qv - 1) / T
  const int n_inter = c < nc - 1 ? (N + T - 1) / T : 0;   // B G_{c+1}: steps over N
  const int steps = n_tgt + n_inter;
  const float* gp = dy + b * gs.b + h * gs.h + (long long)c0 * gs.s + pt * T;
  const float* cbp = cb + ((size_t)b * nc + c) * QP * QP + st * T;    // column tile st
  const float* bp = Bm + b * bs.b + (long long)(c0 + st * T) * bs.s;
  const float* Gp = gst + (((size_t)b * H + h) * nc + c + 1) * N * PS + pt * T;
  auto load = [&](int j) {
    float* at = smem + (j & 1) * 2 * T * SB;
    float* bt = at + T * SB;
    if (j < n_tgt) {
      const int tt = st + j;                       // C B^T rows t of tile tt, read as A[s][t]
      load_tile<T, T, THREADS>(at, SB, cbp + (size_t)tt * T * QP, QP, T, T, true);
      load_tile<T, T, THREADS>(bt, SB, gp + (long long)tt * T * gs.s, gs.s, Qv - tt * T, PT,
                               dy_vec);
    } else {
      const int k = j - n_tgt;
      load_tile<T, T, THREADS>(at, SA, bp + k * T, bs.s, Qv - st * T, N - k * T, bc_vec);
      load_tile<T, T, THREADS>(bt, SB, Gp + (size_t)k * T * PS, PS, N - k * T, PT, true);
    }
  };
  load(0);
  load_tile<T, T, THREADS>(xt, SA, x + b * xs.b + h * xs.h + (long long)(c0 + st * T) * xs.s +
                           pt * T, xs.s, Qv - st * T, PT, x_vec);
  load_tile<T, T, THREADS>(yt, SA, y + b * ys.b + h * ys.h + (long long)(c0 + st * T) * ys.s +
                           pt * T, ys.s, Qv - st * T, PT, y_vec);
  cp_commit();
  chunk_cumsum(cum, dA + b * das.b + h * das.h + (long long)c0 * das.s, das.s, Qv, QP);
  __syncthreads();
  if (pt == 0 && st == 0) {                        // the chunk's cum, once, for stages 4 to 5
    double* out = cumd + (((size_t)b * H + h) * nc + c) * QP;
    for (int i = threadIdx.x; i < QP; i += THREADS) out[i] = cum[i];
  }
  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r = 16 * w + g;                        // the tile's rows r and r + 8
  const int s0 = st * T + r;                       // their positions in the chunk
  const double cs0 = cum[s0], cs1 = cum[s0 + 8];
  const float w0 = n_inter ? (float)exp(cum[Q - 1] - cs0) : 0.f;
  const float w1 = n_inter ? (float)exp(cum[Q - 1] - cs1) : 0.f;
  float acc[8][4];
  zero(acc);
  double dyy[2] = {0.0, 0.0};                      // dy.y over this thread's columns
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // tile j is in; step j - 1 is done
    if (j + 1 < steps) load(j + 1);                // in flight while tile j is multiplied
    cp_commit();
    const float* at = smem + (j & 1) * 2 * T * SB;
    const float* bt = at + T * SB;
    if (j == 0)                                    // bt: dy's rows s (target tile st)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = r + 8 * half, p = 8 * jj + 2 * t + e;
            dyy[half] += (double)bt[q * SB + p] * yt[q * SA + p];
          }
    auto bfetch = [&](int k, int jj) { return bt[k * SB + 8 * jj + g]; };
    if (j < n_tgt) {
      const int t0 = (st + j) * T;
      mma3<T, 8, 2>(acc, [&](int half, int k) {
                const int tq = t0 + k;
                const float v = at[k * SB + r + 8 * half];
                // exp only where t >= s, where cum_t - cum_s <= 0
                return tq >= s0 + 8 * half ? v * expf((float)(cum[tq] - (half ? cs1 : cs0)))
                                           : 0.f;
              }, bfetch);
    } else {
      mma3<T, 8, 2>(acc, [&](int half, int k) { return at[(r + 8 * half) * SA + k]; }, bfetch,
                 w0, w1);
    }
  }
  float* xp = dx + b * dxs.b + h * dxs.h + pt * T;
  double* rp = rpart + (((size_t)b * H + h) * nP + pt) * S + c0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = s0 + 8 * half;
    if (s >= Qv) continue;
    float* row = xp + (long long)(c0 + s) * dxs.s;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = 8 * jj + 2 * t;
      if (dx_vec && p + 1 < PT) {
        *reinterpret_cast<float2*>(row + p) = make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
      } else {
        if (p < PT) row[p] = acc[jj][2 * half];
        if (p + 1 < PT) row[p + 1] = acc[jj][2 * half + 1];
      }
    }
    // r_s's part over this tile of P: dy.y, then minus dx.x, over this thread's
    // 16 columns in double, in column order; then the four threads of the row
    // (t) summed by shuffles
    double v = dyy[half];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v -= (double)acc[jj][2 * half + e] * xt[(r + 8 * half) * SA + 8 * jj + 2 * t + e];
    v += __shfl_xor_sync(0xfu << (threadIdx.x & 28), v, 1);
    v += __shfl_xor_sync(0xfu << (threadIdx.x & 28), v, 2);
    if (t == 0) rp[s] = v;
  }
}

// -- 4. W = sum_h (dy_h x_h^T) o exp(cum_t - cum_s), t >= s ------------------------------

constexpr int W_STAGE = 2 * T * SA + 4 * T;        // floats: dy and x tiles, then 2 T doubles

__host__ __device__ inline size_t w_smem() { return (size_t)2 * W_STAGE * sizeof(float); }

// One block per (target tile tt, source tile st <= tt, chunk; lane), three an
// SM. Each step, (head, tile of P) in order, E's three passes on mma.sync from
// the ring's dy and x tiles; after a head's last tile of P its E, fresh, is
// weighted and added to W in f32.
__global__ void __launch_bounds__(THREADS, 3)
ssd_bwd_w(const float* __restrict__ x, const float* __restrict__ dy,
          const double* __restrict__ cumd, float* __restrict__ W, int S, int H, int P, int Q,
          int QP, int nc, Str3 xs, Str3 gs, int x_vec, int dy_vec) {
  extern __shared__ __align__(16) float smem[];   // 2 stages: dy [t][p], x [s][p], cum_t, cum_s
  const int ntq = QP / T, npair = ntq * (ntq + 1) / 2, nP = (P + T - 1) / T;
  const int pair = blockIdx.x % npair, c = blockIdx.x / npair, b = blockIdx.y;
  int tt = 0;                                      // pair = tt (tt + 1) / 2 + st, st <= tt
  while ((tt + 1) * (tt + 2) / 2 <= pair) ++tt;
  const int st = pair - tt * (tt + 1) / 2;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  if (tt * T >= Qv) return;                        // a tile no stage reads
  const int steps = H * nP;                        // (head, tile of P), heads in order
  auto load = [&](int j) {
    const int h = j / nP, pt = j % nP;
    float* sg = smem + (j & 1) * W_STAGE;
    float* sx = sg + T * SA;
    load_tile<T, T, THREADS>(sg, SA, dy + b * gs.b + h * gs.h + (long long)(c0 + tt * T) * gs.s +
                             pt * T, gs.s, Qv - tt * T, P - pt * T, dy_vec);
    load_tile<T, T, THREADS>(sx, SA, x + b * xs.b + h * xs.h + (long long)(c0 + st * T) * xs.s +
                             pt * T, xs.s, Qv - st * T, P - pt * T, x_vec);
    if (pt == nP - 1) {                            // the step that weights the head's E
      const double* src = cumd + (((size_t)b * H + h) * nc + c) * QP;
      double* cc = reinterpret_cast<double*>(sx + T * SA);
      load_doubles(cc, src + tt * T, T, 0);
      load_doubles(cc + T, src + st * T, T, T / 2);
    }
  };
  load(0);
  cp_commit();
  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r = 16 * w + g;                        // the tile's rows r and r + 8
  float acc[8][4], big[8][4], small[8][4];
  zero(acc);
  zero(big);
  zero(small);
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // step j's tiles are in; step j - 1 is done
    if (j + 1 < steps) load(j + 1);                // in flight while step j is multiplied
    cp_commit();
    const float* sg = smem + (j & 1) * W_STAGE;
    const float* sx = sg + T * SA;
    mma3_passes<T, 8, 4>(big, small, [&](int half, int k) { return sg[(r + 8 * half) * SA + k]; },
                      [&](int k, int jj) { return sx[(8 * jj + g) * SA + k]; });
    if (j % nP != nP - 1) continue;
    // the head's E, fresh accumulators, weighted and added to W in f32
    const double* cc = reinterpret_cast<const double*>(sx + T * SA);
    const double ct[2] = {cc[r], cc[r + 8]};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int el = 0; el < 4; ++el) {
        const int row = r + 8 * (el >> 1), col = 8 * jj + 2 * t + (el & 1);
        const float l = expf((float)(ct[el >> 1] - cc[T + col]));
        if (tt > st || row >= col) acc[jj][el] = fmaf(big[jj][el] + small[jj][el], l, acc[jj][el]);
        big[jj][el] = small[jj][el] = 0.f;
      }
  }
  float* out = W + ((size_t)b * nc + c) * QP * QP + (size_t)(tt * T) * QP + st * T;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8 * half) * QP + 8 * jj + 2 * t) =
          make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
}

// -- 5. dB and dC ----------------------------------------------------------------------

// Shared memory of ssd_bwd_dbc: from a 1 KB boundary the hi and lo tiles of A
// and B (KTILE bytes each), then the two plain tiles of a step (T x SB floats
// each, the cp.async target), then two stages of cum.
constexpr int CUM_STAGE = T + 2;                   // doubles
__host__ __device__ inline size_t dbc_smem() {
  return 1024 + 4 * (size_t)KTILE + 2 * (size_t)T * SB * sizeof(float) +
         2 * (size_t)CUM_STAGE * sizeof(double);
}

struct DbcSmem {
  uint32_t ahi, alo, bhi, blo;                     // shared addresses of the split tiles
  float *at, *bt;                                  // the plain tiles
  double* cum;                                     // [2][CUM_STAGE]
};
__device__ __forceinline__ DbcSmem dbc_layout(unsigned char* raw) {
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  float* plain = reinterpret_cast<float*>(raw + (base - smem_u32(raw)) + 4 * KTILE);
  return {base, base + KTILE, base + 2 * KTILE, base + 3 * KTILE, plain, plain + T * SB,
          reinterpret_cast<double*>(plain + 2 * T * SB)};
}

// One block's tile (it, nt) of dB (isC false: rows s of tile it) or dC (isC
// true: rows t) in chunk c of lane b. First the intra steps on mma.sync from
// the plain tiles: W^T C over the target tiles t >= s (or W B over the source
// tiles s <= t). Then the long product over (h, p) on wgmma, a step per (head,
// tile of P): the step's tiles arrive by cp.async, are split into K-major hi
// and lo tiles, and the next step's loads go out while the warpgroup forms the
// three passes: (w_{h,s} x_{h,s,p}) G_{h,c+1}[n][p] for the chunks before the
// last (or (exp(cum_{h,t}) dy_{h,t,p}) h_{h,c}[n][p] for the chunks after the
// first), each head's slice fresh, weighted per row, added in head order.
template <bool isC>
__device__ __forceinline__ void dbc_tile(
    const DbcSmem& sm, const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ states, const float* __restrict__ gst,
    const float* __restrict__ W, const double* __restrict__ cumd, float* __restrict__ out_base,
    int S, int H, int P, int N, int Q, int QP, int PS, int nc, Str3 xs, Str3 gs, Str2 bs,
    Str2 cs, int x_vec, int dy_vec, int bc_vec, int it, int nt, int c, int b) {
  const int nP = (P + T - 1) / T;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  const int NT = min(T, N - nt * T);
  const int last_tile = (Qv - 1) / T;
  const int n_intra = isC ? it + 1 : last_tile - it + 1;
  const bool inter = isC ? c > 0 : c < nc - 1;
  const int steps = n_intra + (inter ? H * nP : 0);
  const float* wp = W + ((size_t)b * nc + c) * QP * QP;
  // the partner of the intra steps: C rows t (dB) or B rows s (dC), columns of tile nt
  const float* mp = isC ? Bm + b * bs.b + (long long)c0 * bs.s + nt * T
                        : Cm + b * cs.b + (long long)c0 * cs.s + nt * T;
  const long long ms = isC ? bs.s : cs.s;
  // the rows of the inter steps: dy rows t (dC) or x rows s (dB)
  const float* op = isC ? dy + b * gs.b + (long long)(c0 + it * T) * gs.s
                        : x + b * xs.b + (long long)(c0 + it * T) * xs.s;
  const long long oh = isC ? gs.h : xs.h, os = isC ? gs.s : xs.s;
  const int o_vec = isC ? dy_vec : x_vec;
  // their partner: the state h_c (dC) or its gradient G_{c+1} (dB), [n][p]
  const float* sp = (isC ? states + ((size_t)b * H * nc + c) * N * PS
                         : gst + ((size_t)b * H * nc + c + 1) * N * PS) + (size_t)nt * T * PS;
  const size_t sh = (size_t)nc * N * PS;           // a head's stride in either
  auto load = [&](int j) {
    if (j < n_intra) {
      const int k = isC ? j : it + j;              // W's tile (it, k) for dC, (k, it) for dB
      load_tile<T, T, THREADS>(sm.at, isC ? SA : SB,
                               wp + (size_t)(isC ? it : k) * T * QP + (isC ? k : it) * T, QP, T,
                               T, true);
      load_tile<T, T, THREADS>(sm.bt, SB, mp + (long long)k * T * ms, ms, Qv - k * T, NT, bc_vec);
    } else {
      const int h = (j - n_intra) / nP, pt = (j - n_intra) % nP;
      load_tile<T, T, THREADS>(sm.at, SA, op + h * oh + pt * T, os, Qv - it * T, P - pt * T,
                               o_vec);
      load_tile<T, T, THREADS>(sm.bt, SA, sp + h * sh + pt * T, PS, NT, P - pt * T, true);
      if (pt == nP - 1) {                          // the step that weights the head's slice
        const double* src = cumd + (((size_t)b * H + h) * nc + c) * QP;
        double* cc = sm.cum + (j & 1) * CUM_STAGE;
        load_doubles(cc, src + it * T, T, 0);
        load_doubles(cc + T, src + QP - 2, 2, T / 2);   // cc[T + 1]: last
      }
    }
  };
  load(0);
  cp_commit();
  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r = 16 * w + g;                        // the tile's rows r and r + 8
  float acc[8][4];
  zero(acc);
  int j = 0;
  for (; j < n_intra; ++j) {
    cp_wait_all();
    __syncthreads();                               // step j's tiles are in
    auto bfetch = [&](int k, int jj) { return sm.bt[k * SB + 8 * jj + g]; };
    if (isC)                                       // W[t][s], rows t
      mma3<T, 8>(acc, [&](int half, int k) { return sm.at[(r + 8 * half) * SA + k]; }, bfetch);
    else                                           // W[t][s] read as W^T, rows s
      mma3<T, 8>(acc, [&](int half, int k) { return sm.at[k * SB + r + 8 * half]; }, bfetch);
    __syncthreads();                               // the plain tiles are free
    if (j + 1 < steps) load(j + 1);
    cp_commit();
  }
  float big[8][4], small[8][4];                    // a head's slice, fresh
  for (; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // step j's tiles are in
    split_kmajor(sm.at, SA, sm.ahi, sm.alo);       // A = x or dy [row][p]
    split_kmajor(sm.bt, SA, sm.bhi, sm.blo);       // B = G or h [n][p]
    fence_async_smem();
    __syncthreads();                               // the split tiles are in; the plain ones free
    if (j + 1 < steps) load(j + 1);                // in flight while step j is multiplied
    cp_commit();
    if ((j - n_intra) % nP == 0) {
      zero(big);
      zero(small);
    }
    wgmma3_passes(big, small, sm.ahi, sm.alo, sm.bhi, sm.blo);
    if ((j - n_intra) % nP != nP - 1) continue;
    // the head's slice, weighted per row and added in f32, heads in order
    const double* cc = sm.cum + (j & 1) * CUM_STAGE;
    const float f0 = (float)exp(isC ? cc[r] : cc[T + 1] - cc[r]);
    const float f1 = (float)exp(isC ? cc[r + 8] : cc[T + 1] - cc[r + 8]);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int el = 0; el < 4; ++el)
        acc[jj][el] = fmaf(el < 2 ? f0 : f1, big[jj][el] + small[jj][el], acc[jj][el]);
  }
  float* out = out_base + ((size_t)b * S + c0 + it * T) * N + nt * T;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = r + 8 * half;
    if (it * T + q >= Qv) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = 8 * jj + 2 * t;
      if (n < NT) out[(size_t)q * N + n] = acc[jj][2 * half];
      if (n + 1 < NT) out[(size_t)q * N + n + 1] = acc[jj][2 * half + 1];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ states, const float* __restrict__ gst,
            const float* __restrict__ W, const double* __restrict__ cumd,
            float* __restrict__ dB, float* __restrict__ dC, int S, int H, int P, int N, int Q,
            int QP, int PS, int nc, Str3 xs, Str3 gs, Str2 bs, Str2 cs, int x_vec, int dy_vec,
            int bc_vec) {
  extern __shared__ __align__(16) unsigned char wsm[];
  const DbcSmem sm = dbc_layout(wsm);
  const int nN = (N + T - 1) / T, ntq = QP / T;
  int idx = blockIdx.x;
  const int nt = idx % nN;
  idx /= nN;
  const int it = idx % ntq;
  idx /= ntq;
  const int which = idx % 2, c = idx / 2, b = blockIdx.y;
  if (it * T >= min(Q, S - c * Q)) return;         // a tile past the end of the last chunk
  if (which)
    dbc_tile<true>(sm, x, dy, Bm, Cm, states, gst, W, cumd, dC, S, H, P, N, Q, QP, PS, nc, xs,
                   gs, bs, cs, x_vec, dy_vec, bc_vec, it, nt, c, b);
  else
    dbc_tile<false>(sm, x, dy, Bm, Cm, states, gst, W, cumd, dB, S, H, P, N, Q, QP, PS, nc, xs,
                    gs, bs, cs, x_vec, dy_vec, bc_vec, it, nt, c, b);
}


// -- 6. ddA ----------------------------------------------------------------------------

// One block per (head, lane): r's nP partials per position summed in tile
// order, then summed from the end of the sequence in double, DDA_THREADS x
// DDA_PER positions a round: each thread its run of DDA_PER from its end, then
// the runs of the threads before it (later positions) and of the rounds past.
__global__ void __launch_bounds__(DDA_THREADS)
ssd_bwd_ddA(const double* __restrict__ rpart, float* __restrict__ ddA, int S, int nP, Str3 das) {
  __shared__ double part[DDA_THREADS / 32];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const double* rp = rpart + ((size_t)b * H + h) * nP * S;
  float* op = ddA + b * das.b + h * das.h;
  double carry = 0.0;                              // the sum past this round
  for (long long end = S; end > 0; end -= DDA_THREADS * DDA_PER) {
    const long long hi = end - (long long)threadIdx.x * DDA_PER;   // past this thread's run
    double v[DDA_PER], run = 0.0;
#pragma unroll
    for (int k = 0; k < DDA_PER; ++k) {           // from the run's end back
      const long long tp = hi - 1 - k;
      double rv = 0.0;
      if (tp >= 0)
        for (int pt = 0; pt < nP; ++pt) rv += rp[(size_t)pt * S + tp];
      run += rv;
      v[k] = run;
    }
    double incl = run;                             // the runs of lanes 0 .. lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    double before = carry + (lane ? excl : 0.0), round = 0.0;
    for (int i = 0; i < DDA_THREADS / 32; ++i) {
      if (i < warp) before += part[i];
      round += part[i];
    }
#pragma unroll
    for (int k = 0; k < DDA_PER; ++k) {
      const long long tp = hi - 1 - k;
      if (tp >= 0) op[tp * das.s] = (float)(before + v[k]);
    }
    carry += round;
    __syncthreads();                               // part is read before the next round writes it
  }
}

}  // namespace

// Launcher: x, y (K5's output), dy and dx (B,H,S,P), each given by its
// pointer and its strides over (lane, head, position); dA and ddA (B,H,S)
// likewise; B and C (B,S,N) by their strides over (lane, position); dB and dC
// (B,S,N) contiguous. The last dim of x, y, dy, dx, B and C is contiguous.
// `strides` holds 22 values: x's three, dA's three, B's two, C's two, y's
// three, dy's three, dx's three, ddA's three. cb, states and decays are K5's
// scratch of the forward call on the same inputs, as it left them. From the
// caller: gst (B, H, nc, N, PS) float32 (unused, may be null, when nc == 1),
// W (B, nc, QP, QP) float32, cum (B, H, nc, QP) and r (B, H, nP, S) float64.
// `sizes` holds the element counts of cb, states, decays, gst, W, cum and r
// as allocated, and a scratch smaller than its layout is refused with
// cudaErrorInvalidValue before any launch. Launches the stages on `stream`
// (stage 1 only for nc > 1, stage 2 only for nc > 2) and returns the first
// cudaGetLastError() that is not success.
extern "C" int launch_ssd_scan_bwd_f32(const float* x, const float* dA, const float* Bm,
                                       const float* Cm, const float* y, const float* dy,
                                       const float* cb, const float* states,
                                       const float* decays, float* dx, float* ddA, float* dB,
                                       float* dC, float* gst, float* W, double* cumd,
                                       double* rpart, int Bn, int H, int S, int P, int N, int Q,
                                       const long long* st, const long long* sizes,
                                       void* stream) {
  if (Bn <= 0 || H <= 0 || S <= 0 || P <= 0 || N <= 0 || N > MAX_N || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const Str3 xs{st[0], st[1], st[2]}, das{st[3], st[4], st[5]}, ys{st[10], st[11], st[12]};
  const Str2 bs{st[6], st[7]}, cs{st[8], st[9]};
  const Str3 gs{st[13], st[14], st[15]}, dxs{st[16], st[17], st[18]};
  const Str3 ddas{st[19], st[20], st[21]};
  const int nc = (S + Q - 1) / Q, QP = round_up(Q, T), PS = round_up(P, 4);
  const int ntq = QP / T, nP = (P + T - 1) / T, nN = (N + T - 1) / T;
  const long long chunks = (long long)Bn * nc, heads = nc > 1 ? chunks * H : 0;
  if (sizes[0] < chunks * QP * QP || sizes[1] < heads * N * PS || sizes[2] < heads ||
      sizes[3] < heads * N * PS || sizes[4] < chunks * QP * QP ||
      sizes[5] < chunks * H * QP || sizes[6] < (long long)Bn * H * nP * S)
    return (int)cudaErrorInvalidValue;
  const int x_vec = rows_of_16_bytes(x, xs.b, xs.h, xs.s);
  const int dy_vec = rows_of_16_bytes(dy, gs.b, gs.h, gs.s);
  const int y_vec = rows_of_16_bytes(y, ys.b, ys.h, ys.s);
  const int bc_vec = rows_of_16_bytes(Bm, bs.b, bs.s, 0) && rows_of_16_bytes(Cm, cs.b, cs.s, 0);
  const int dx_vec = reinterpret_cast<uintptr_t>(dx) % 8 == 0 && (dxs.b | dxs.h | dxs.s) % 2 == 0;
  const size_t s1 = state_smem(QP), s3 = dx_smem(QP), s4 = w_smem(), s5 = dbc_smem();
  if (s1 > (size_t)SMEM_LIMIT || s3 > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static size_t allowed1 = 48 * 1024, allowed3 = 48 * 1024, allowed4 = 48 * 1024,
                allowed5 = 48 * 1024;
  cudaError_t e;
  if ((e = allow_smem(ssd_chunk_state<true>, s1, allowed1)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_bwd_dx, s3, allowed3)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_bwd_w, s4, allowed4)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_bwd_dbc, s5, allowed5)) != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;

  if (nc > 1) {
    ssd_chunk_state<true><<<dim3((nc - 1) * nP, H, Bn), STATE_THREADS, s1, s>>>(
        dy, dA, Cm, gst, nullptr, S, P, N, Q, QP, PS, nc, gs, das, cs, dy_vec, bc_vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (nc > 2) {
    const int NPS = N * PS;
    ssd_bwd_state_pass<<<dim3((NPS / 4 + PASS_THREADS - 1) / PASS_THREADS, H, Bn), PASS_THREADS,
                         0, s>>>(gst, decays, nc, NPS);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_bwd_dx<<<dim3(H * nP * ntq * nc, Bn), THREADS, s3, s>>>(
      x, y, dy, dA, Bm, cb, gst, dx, cumd, rpart, S, H, P, N, Q, QP, PS, nc, xs, ys, gs, das,
      bs, dxs, x_vec, y_vec, dy_vec, bc_vec, dx_vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_w<<<dim3(ntq * (ntq + 1) / 2 * nc, Bn), THREADS, s4, s>>>(
      x, dy, cumd, W, S, H, P, Q, QP, nc, xs, gs, x_vec, dy_vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dbc<<<dim3(nc * 2 * ntq * nN, Bn), THREADS, s5, s>>>(
      x, dy, Bm, Cm, states, gst, W, cumd, dB, dC, S, H, P, N, Q, QP, PS, nc, xs, gs, bs, cs,
      x_vec, dy_vec, bc_vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_ddA<<<dim3(H, Bn), DDA_THREADS, 0, s>>>(rpart, ddA, S, nP, ddas);
  return (int)cudaGetLastError();
}
