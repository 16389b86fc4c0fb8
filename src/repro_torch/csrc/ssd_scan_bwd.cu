// The backward of the Mamba-2 SSD chunked scan (S3) in float32, chunk-parallel,
// its products on the tensor cores in 3xTF32: the gradients of K5's inputs x,
// dA, B and C from the gradient dy of its output.
//
// Replaces: no TPU kernel. The reference trains through XLA's autodiff of its
// jnp SSD core, src/repro/models/ssd.py:80 (`ssd_core_chunked` under
// `jax.value_and_grad`, src/repro/train/steps.py:104); no Pallas kernel of
// the reference has a VJP.
//
// Per chunk c of Q positions, with cum = cumsum(dA) inside the chunk, last its
// last position, w_s = exp(last - cum_s), h_c the state entering the chunk
// (K5's `states`) and G_c the gradient of h_c:
//   G_c = (C o exp(cum))^T dy + exp(last) G_{c+1}, G_nc = 0
//   dx_s = sum_{t >= s} (C_t . B_s) exp(cum_t - cum_s) dy_t + w_s B_s^T G_{c+1}
//   dB_s = sum_h [ sum_{t >= s} exp(cum_t - cum_s) (dy_t . x_s) C_t + w_s G_{c+1} x_s ]
//   dC_t = sum_h [ sum_{s <= t} exp(cum_t - cum_s) (dy_t . x_s) B_s + exp(cum_t) h_c dy_t ]
//   ddA_t = sum over t' >= t, to the end of the sequence, of dy_t'.y_t' - dx_t'.x_t'
// The last line is the step recurrence's ddA_t = exp(dA_t) <dh_t, h_{t-1}>
// summed by parts: <dh_t, h_t> = dy_t.y_t + <dh_{t+1}, h_{t+1}> - dx_{t+1}.x_{t+1}
// and h_t - B_t x_t^T = exp(dA_t) h_{t-1}, so it needs only K5's y and the dx
// this kernel forms (tests/test_torch_scan_bwd.py holds the chunked formulas
// to the step-by-step backward in float64, and emulates them in 3xTF32).
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
//      transposed, target tiles t >= s, then B_s G_{c+1} weighted by w_s.
//   4. ssd_bwd_dbc, one block per (head, dB or dC, tile of N, 64-row tile,
//      chunk; lane): for each partner tile, E = dy x^T (or x dy^T) on the
//      tensor cores, weighted by exp(cum_t - cum_s) where t >= s, through
//      shared memory into the product with C (or B); then x G_{c+1}^T weighted
//      by w (or dy h_c^T by exp(cum)). Each head's part goes into a
//      (2, B, H, S, N) scratch.
//   5. ssd_bwd_head_sum: dB and dC, the parts summed over the heads in head
//      order. No float atomics: two runs give the same bits.
//   6. ssd_bwd_ddA, one block per (head, lane): dy.y - dx.x per position in
//      double, summed from the end of the sequence in double.
// A call of one chunk skips stages 1 and 2, of two chunks stage 2.
//
// Numerics are K5's: cum and every difference of it in double before its exp,
// exp only where t >= s (the exponent is then at most 0), each product in
// three TF32 passes whose sums are kept apart (mma3). A ragged tail, N and P
// off the tiles are masked by zero-filled loads and stores that skip them.
//
// Bound on this card: operations, products at 3xTF32's 494.7 / 3 TFLOP/s. At
// Mamba-2's training shape (B 4, S 2048, H 48, P 64, N 128, Q 256) the
// products of the formulas above over the causal pairs (chip_smoke.py's
// `ssd_bwd_flops`) against x, dA, B, C, y, dy and the kept scratch read once
// and dx, ddA, dB, dC written once. The design does more: E is formed twice
// (for dB and for dC), the diagonal tiles' upper halves, and the per-head
// parts of dB and dC (403 MB written and read at that shape).
#include "ssd_common.cuh"

namespace {

constexpr int DDA_THREADS = 256;   // positions a round of ssd_bwd_ddA, one a thread

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

// -- 3. dx ---------------------------------------------------------------------------

__host__ __device__ inline size_t dx_smem(int QP) {
  return (size_t)2 * 2 * T * SB * sizeof(float) + (size_t)QP * sizeof(double);
}

__global__ void __launch_bounds__(THREADS)
ssd_bwd_dx(const float* __restrict__ dy, const float* __restrict__ dA,
           const float* __restrict__ Bm, const float* __restrict__ cb,
           const float* __restrict__ gst, float* __restrict__ dx, int S, int H, int P, int N,
           int Q, int QP, int PS, int nc, Str3 gs, Str3 das, Str2 bs, Str3 dxs, int dy_vec,
           int bc_vec, int dx_vec) {
  extern __shared__ __align__(16) float smem[];   // 2 stages of A then B, T x SB each
  double* cum = reinterpret_cast<double*>(smem + 2 * 2 * T * SB);
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
  cp_commit();
  chunk_cumsum(cum, dA + b * das.b + h * das.h + (long long)c0 * das.s, das.s, Qv, QP);
  __syncthreads();
  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r = 16 * w + g;                        // the tile's rows r and r + 8
  const int s0 = st * T + r;                       // their positions in the chunk
  const double cs0 = cum[s0], cs1 = cum[s0 + 8];
  const float w0 = n_inter ? (float)exp(cum[Q - 1] - cs0) : 0.f;
  const float w1 = n_inter ? (float)exp(cum[Q - 1] - cs1) : 0.f;
  float acc[8][4];
  zero(acc);
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // tile j is in; step j - 1 is done
    if (j + 1 < steps) load(j + 1);                // in flight while tile j is multiplied
    cp_commit();
    const float* at = smem + (j & 1) * 2 * T * SB;
    const float* bt = at + T * SB;
    auto bfetch = [&](int k, int jj) { return bt[k * SB + 8 * jj + g]; };
    if (j < n_tgt) {
      const int t0 = (st + j) * T;
      mma3<T, 8>(acc, [&](int half, int k) {
                const int tq = t0 + k;
                const float v = at[k * SB + r + 8 * half];
                // exp only where t >= s, where cum_t - cum_s <= 0
                return tq >= s0 + 8 * half ? v * expf((float)(cum[tq] - (half ? cs1 : cs0)))
                                           : 0.f;
              }, bfetch);
    } else {
      mma3<T, 8>(acc, [&](int half, int k) { return at[(r + 8 * half) * SA + k]; }, bfetch,
                 w0, w1);
    }
  }
  float* xp = dx + b * dxs.b + h * dxs.h + pt * T;
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
  }
}

// -- 4. each head's part of dB and dC ----------------------------------------------------

__host__ __device__ inline size_t dbc_smem(int QP) {
  return (size_t)4 * T * SB * sizeof(float) + (size_t)QP * sizeof(double);
}

// which 0, dB: own rows x_s, partner rows dy_t for t >= s, M = C; then
//   w_s x_s G_{c+1}^T for the chunks before the last.
// which 1, dC: own rows dy_t, partner rows x_s for s <= t, M = B; then
//   exp(cum_t) dy_t h_c^T for the chunks after the first.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dbc(const float* __restrict__ x, const float* __restrict__ dy,
            const float* __restrict__ dA, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ states,
            const float* __restrict__ gst, float* __restrict__ parts, int S, int H, int P, int N,
            int Q, int QP, int PS, int nc, Str3 xs, Str3 gs, Str3 das, Str2 bs, Str2 cs,
            int x_vec, int dy_vec, int bc_vec) {
  extern __shared__ __align__(16) float smem[];
  float* so = smem;                                // own rows [r][p]
  float* sp = so + T * SB;                         // partner rows [j][p], or a state's [n][p]
  float* se = sp + T * SB;                         // E o exp(...) [r][j]
  float* sm = se + T * SB;                         // M [j][n]
  double* cum = reinterpret_cast<double*>(sm + T * SB);
  const int nN = (N + T - 1) / T, ntq = QP / T, nP = (P + T - 1) / T;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int which = idx % 2;
  idx /= 2;
  const int nt = idx % nN;
  idx /= nN;
  const int it = idx % ntq, c = idx / ntq, b = blockIdx.y;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  if (it * T >= Qv) return;                        // a tile past the end of the last chunk
  const bool dC = which == 1;
  const int NT = min(T, N - nt * T);
  const float* xp = x + b * xs.b + h * xs.h + (long long)c0 * xs.s;
  const float* gp = dy + b * gs.b + h * gs.h + (long long)c0 * gs.s;
  const float* op = dC ? gp : xp;
  const float* pp = dC ? xp : gp;
  const long long os = dC ? gs.s : xs.s, ps = dC ? xs.s : gs.s;
  const int o_vec = dC ? dy_vec : x_vec, p_vec = dC ? x_vec : dy_vec;
  const float* mp = dC ? Bm + b * bs.b + (long long)c0 * bs.s + nt * T
                       : Cm + b * cs.b + (long long)c0 * cs.s + nt * T;
  const long long ms = dC ? bs.s : cs.s;
  const int jlo = dC ? 0 : it, jhi = dC ? it : (Qv - 1) / T;
  const bool inter = dC ? c > 0 : c < nc - 1;
  const float* slot = (dC ? states + (((size_t)b * H + h) * nc + c) * N * PS
                          : gst + (((size_t)b * H + h) * nc + c + 1) * N * PS) +
                      (size_t)nt * T * PS;
  chunk_cumsum(cum, dA + b * das.b + h * das.h + (long long)c0 * das.s, das.s, Qv, QP);
  __syncthreads();
  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r = 16 * w + g;                        // the tile's rows r and r + 8
  const int q0 = it * T + r;                       // their positions in the chunk
  auto own = [&](int half, int k) { return so[(r + 8 * half) * SA + k]; };
  auto load_own = [&](int k) {
    load_tile<T, T, THREADS>(so, SA, op + (long long)it * T * os + k * T, os, Qv - it * T,
                             P - k * T, o_vec);
  };
  float acc[8][4];
  zero(acc);
  for (int j = jlo; j <= jhi; ++j) {
    float e[8][4];
    zero(e);
    for (int k = 0; k < nP; ++k) {
      __syncthreads();                             // every read of so and sp is done
      load_own(k);
      load_tile<T, T, THREADS>(sp, SA, pp + (long long)j * T * ps + k * T, ps, Qv - j * T,
                               P - k * T, p_vec);
      cp_commit();
      cp_wait_all();
      __syncthreads();
      mma3<T, 8>(e, own, [&](int kk, int jj) { return sp[(8 * jj + g) * SA + kk]; });
    }
    // E's element at row q0 + 8 (el / 2), partner position j T + 8 jj + 2 t + el % 2,
    // weighted by exp(cum_t - cum_s) where t >= s, into this warp's rows of se
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int el = 0; el < 4; ++el) {
        const int q = q0 + 8 * (el >> 1), col = 8 * jj + 2 * t + (el & 1), u = j * T + col;
        const bool on = dC ? u <= q : u >= q;
        const double d = dC ? cum[q] - cum[u] : cum[u] - cum[q];
        se[(r + 8 * (el >> 1)) * SA + col] = on ? e[jj][el] * expf((float)d) : 0.f;
      }
    load_tile<T, T, THREADS>(sm, SB, mp + (long long)j * T * ms, ms, Qv - j * T, NT, bc_vec);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    mma3<T, 8>(acc, [&](int half, int k) { return se[(r + 8 * half) * SA + k]; },
               [&](int k, int jj) { return sm[k * SB + 8 * jj + g]; });
  }
  if (inter) {
    const double last = cum[Q - 1];
    const float f0 = (float)exp(dC ? cum[q0] : last - cum[q0]);
    const float f1 = (float)exp(dC ? cum[q0 + 8] : last - cum[q0 + 8]);
    for (int k = 0; k < nP; ++k) {
      __syncthreads();
      load_own(k);
      load_tile<T, T, THREADS>(sp, SA, slot + k * T, PS, NT, P - k * T, true);
      cp_commit();
      cp_wait_all();
      __syncthreads();
      mma3<T, 8>(acc, own, [&](int kk, int jj) { return sp[(8 * jj + g) * SA + kk]; }, f0, f1);
    }
  }
  float* out = parts + ((((size_t)which * gridDim.y + b) * H + h) * S + c0) * N + nt * T;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + 8 * half;
    if (q >= Qv) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = 8 * jj + 2 * t;
      if (n < NT) out[(size_t)q * N + n] = acc[jj][2 * half];
      if (n + 1 < NT) out[(size_t)q * N + n + 1] = acc[jj][2 * half + 1];
    }
  }
}

// -- 5. dB and dC: the parts summed over the heads -------------------------------------

// parts (2, B, H, S, N); dB and dC (B, S, N) contiguous; `sn` = S N, `total` = B S N
__global__ void __launch_bounds__(256)
ssd_bwd_head_sum(const float* __restrict__ parts, float* __restrict__ dB, float* __restrict__ dC,
                 int H, long long sn, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * total) return;
  const int which = i >= total;
  const long long e = i - which * total, b = e / sn;
  const float* p = parts + ((which * (total / sn) + b) * H) * sn + e % sn;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += p[h * sn];
  (which ? dC : dB)[e] = s;
}

// -- 6. ddA ----------------------------------------------------------------------------

// One block per (head, lane). The sequence in rounds of DDA_THREADS positions
// from its end: each warp forms dy.y - dx.x of its positions (lanes over P,
// in double), then warp 0 sums them from the end in double and stores ddA.
__global__ void __launch_bounds__(DDA_THREADS)
ssd_bwd_ddA(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ dy, const float* __restrict__ dx, float* __restrict__ ddA,
            int S, int P, Str3 xs, Str3 ys, Str3 gs, Str3 dxs, Str3 das) {
  __shared__ double rv[DDA_THREADS];
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xp = x + b * xs.b + h * xs.h;
  const float* yp = y + b * ys.b + h * ys.h;
  const float* gp = dy + b * gs.b + h * gs.h;
  const float* dp = dx + b * dxs.b + h * dxs.h;
  float* op = ddA + b * das.b + h * das.h;
  double carry = 0.0;                              // warp 0: the sum past this round
  for (int end = S; end > 0; end -= DDA_THREADS) {
    for (int i = warp; i < DDA_THREADS; i += DDA_THREADS / 32) {
      const long long tp = end - 1 - i;            // i counts back from the round's end
      double v = 0.0;
      if (tp >= 0)
        for (int p = lane; p < P; p += 32)
          v += (double)gp[tp * gs.s + p] * yp[tp * ys.s + p] -
               (double)dp[tp * dxs.s + p] * xp[tp * xs.s + p];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) rv[i] = v;
    }
    __syncthreads();
    if (warp == 0) {
      for (int base = 0; base < DDA_THREADS; base += 32) {
        double v = rv[base + lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        const long long tp = end - 1 - (base + lane);
        if (tp >= 0) op[tp * das.s] = (float)v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();                               // rv is read before the next round writes it
  }
}

}  // namespace

// Launcher: x, y (K5's output), dy and dx (B,H,S,P), each given by its
// pointer and its strides over (lane, head, position); dA and ddA (B,H,S)
// likewise; B and C (B,S,N) by their strides over (lane, position); dB and dC
// (B,S,N) contiguous. The last dim of x, y, dy, dx, B and C is contiguous.
// `strides` holds 22 values: x's three, dA's three, B's two, C's two, y's
// three, dy's three, dx's three, ddA's three. cb, states and decays are K5's
// scratch of the forward call on the same inputs, as it left them; gst
// (B, H, nc, N, PS) (unused, may be null, when nc == 1) and parts
// (2, B, H, S, N) are float32 scratch from the caller. `sizes` holds the
// element counts of cb, states, decays, gst and parts as allocated, and a
// scratch smaller than its layout is refused with cudaErrorInvalidValue
// before any launch. Launches the stages on `stream` (stage 1 only for
// nc > 1, stage 2 only for nc > 2) and returns the first cudaGetLastError()
// that is not success.
extern "C" int launch_ssd_scan_bwd_f32(const float* x, const float* dA, const float* Bm,
                                       const float* Cm, const float* y, const float* dy,
                                       const float* cb, const float* states,
                                       const float* decays, float* dx, float* ddA, float* dB,
                                       float* dC, float* gst, float* parts, int Bn, int H, int S,
                                       int P, int N, int Q, const long long* st,
                                       const long long* sizes, void* stream) {
  if (Bn <= 0 || H <= 0 || S <= 0 || P <= 0 || N <= 0 || N > MAX_N || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const Str3 xs{st[0], st[1], st[2]}, das{st[3], st[4], st[5]}, ys{st[10], st[11], st[12]};
  const Str2 bs{st[6], st[7]}, cs{st[8], st[9]};
  const Str3 gs{st[13], st[14], st[15]}, dxs{st[16], st[17], st[18]};
  const Str3 ddas{st[19], st[20], st[21]};
  const int nc = (S + Q - 1) / Q, QP = round_up(Q, T), PS = round_up(P, 4);
  const long long chunks = (long long)Bn * nc, heads = nc > 1 ? chunks * H : 0;
  const long long total = (long long)Bn * S * N;
  if (sizes[0] < chunks * QP * QP || sizes[1] < heads * N * PS || sizes[2] < heads ||
      sizes[3] < heads * N * PS || sizes[4] < 2 * total * H)
    return (int)cudaErrorInvalidValue;
  const int ntq = QP / T, nP = (P + T - 1) / T, nN = (N + T - 1) / T;
  const int x_vec = rows_of_16_bytes(x, xs.b, xs.h, xs.s);
  const int dy_vec = rows_of_16_bytes(dy, gs.b, gs.h, gs.s);
  const int bc_vec = rows_of_16_bytes(Bm, bs.b, bs.s, 0) && rows_of_16_bytes(Cm, cs.b, cs.s, 0);
  const int dx_vec = reinterpret_cast<uintptr_t>(dx) % 8 == 0 && (dxs.b | dxs.h | dxs.s) % 2 == 0;
  const size_t s1 = state_smem(QP), s3 = dx_smem(QP), s4 = dbc_smem(QP);
  if (s1 > (size_t)SMEM_LIMIT || s3 > (size_t)SMEM_LIMIT || s4 > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  static size_t allowed1 = 48 * 1024, allowed3 = 48 * 1024, allowed4 = 48 * 1024;
  cudaError_t e;
  if ((e = allow_smem(ssd_chunk_state<true>, s1, allowed1)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_bwd_dx, s3, allowed3)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_bwd_dbc, s4, allowed4)) != cudaSuccess) return (int)e;
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
      dy, dA, Bm, cb, gst, dx, S, H, P, N, Q, QP, PS, nc, gs, das, bs, dxs, dy_vec, bc_vec,
      dx_vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_dbc<<<dim3(H * 2 * nN * ntq * nc, Bn), THREADS, s4, s>>>(
      x, dy, dA, Bm, Cm, states, gst, parts, S, H, P, N, Q, QP, PS, nc, xs, gs, das, bs, cs,
      x_vec, dy_vec, bc_vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_head_sum<<<(unsigned)((2 * total + 255) / 256), 256, 0, s>>>(parts, dB, dC, H,
                                                                      (long long)S * N, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_ddA<<<dim3(H, Bn), DDA_THREADS, 0, s>>>(x, y, dy, dx, ddA, S, P, xs, ys, gs, dxs,
                                                   ddas);
  return (int)cudaGetLastError();
}
