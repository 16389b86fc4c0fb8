// Mamba-2 SSD chunked scan (state-space duality) in float32, chunk-parallel,
// its products on the tensor cores in 3xTF32.
//
// Replaces: repro/kernels/ssd_scan.py:71, the `pallas_call` of `_ssd_kernel`
// (grid (B, H, nc), the chunk dimension innermost and sequential on the TPU,
// the state h (N, P) carried in VMEM scratch from one chunk to the next).
//
// Per chunk c of Q positions, with cum = cumsum(dA) inside the chunk:
//   y = ((C B^T) o tril(exp(cum_q - cum_s))) x  +  (C o exp(cum)) h_c
//   h_{c+1} = exp(cum_last) h_c + (B o exp(cum_last - cum))^T x
// x (B,H,S,P) and dA (B,H,S) per head; B and C (B,S,N) shared by the heads.
//
// Design: the chunk-parallel form of the SSD algorithm (Dao & Gu,
// arXiv:2405.21060, section 6), four launches on the caller's stream, each
// over blocks that run in any order:
//   1. ssd_chunk_cb, one block per (causal 64x64 tile pair, chunk, lane):
//      C B^T once for all heads into a (B, nc, QP, QP) scratch (QP: Q rounded
//      up to 64); only tiles on or below the diagonal are formed and read.
//   2. ssd_chunk_state, one block per (chunk but the last, tile of P, head,
//      lane): cum in double, the chunk's state increment
//      dH_c = (B o exp(last - cum))^T x as (N, P) f32 into slot c + 1 of a
//      (B, H, nc, N, PS) scratch (PS: P rounded up to 4), and exp(last) into
//      slot c + 1 of a (B, H, nc) scratch of decays.
//   3. ssd_state_pass, one block per (slice of the N x PS state, head, lane):
//      the only sequential part, element-wise: h_1 = dH_0 and
//      h_c = exp(last_{c-1}) h_{c-1} + dH_{c-1}, written over dH_{c-1} in
//      slot c, so slot c ends as h_c, the state entering chunk c (h_0 = 0 is
//      never stored: chunk 0 has no inter-chunk term).
//   4. ssd_chunk_scan, one block per (head, tile of P, 64-row query tile,
//      chunk; lane), the head fastest, so that the heads that read one tile
//      of C B^T meet it in L2: y_q = exp(cum_q) (C_q h_c) + sum over source
//      tiles s <= q of (CB_qs o L_qs) x_s. On the diagonal tile L is formed
//      in registers from differences of cum in double, exp only on and below
//      the diagonal (above it the difference is positive and may overflow:
//      those weights are 0); a tile before it takes L_qs as
//      exp(cum_q - cum_r) exp(cum_r - cum_s), r the query tile's first row,
//      both factors at most 1, from two tables the block forms once.
// A launch of one chunk skips stages 2 and 3, of two chunks stage 3.
//
// Every product is mma.sync m16n8k8 on TF32 in three passes: each operand a
// splits into hi = a rounded to TF32 (to nearest, as cvt.rna.tf32.f32) and
// lo = a - hi rounded alike; the f32 accumulators take lo.hi + hi.lo and
// hi.hi. One TF32 pass keeps some 11 bits of each operand: emulated on the
// CPU (tests/test_torch_ssd_hopper.py) at S 1024, P 64, N 128, Q 256 against
// the float64 recurrence, the worst error over its limit 2e-4 + 2e-4 |y| is
// 152x (decay logs in [-0.5, -0.01]) and 457x (Mamba-2's [-0.02, -0.001])
// with one pass, 0.09x and 0.31x with three. So three passes. The tensor
// cores also round each mma's sum toward zero: with every pass of a query
// tile summed in one accumulator, the card missed that limit at the 4 x 2048
// prefill with slow decays; with the sums kept apart (mma3) it stays within
// a third of it (chip_smoke.py).
// The decay logs are summed and differenced in double before each exp (in
// float32, cum reaches some -64 within a chunk of 256 at Mamba-2's widths, and
// its rounding alone puts a chunked scan outside 2e-4 of the recurrence).
// Tiles arrive by cp.async into a ring of two stages, so that the next tile's
// load overlaps the current tile's products. A ragged tail (S not a multiple
// of Q), N and P off the tiles are masked here: rows and columns past them are
// zero-filled on load and not stored, which is the function of the
// reference's zero padding.
//
// Bound on this card: operations. Counting C B^T once per lane and chunk and
// only the causal pairs, the prefill of Mamba-2 (B 4, S 2048, H 48, P 64,
// N 128, Q 256) needs 18.07 GFLOP; at 3xTF32's effective 494.7 / 3 = 164.9
// TFLOP/s that is 0.1096 ms, against 0.063 ms for its 211 MB of inputs and
// outputs at 3.35 TB/s. (Before this design the products ran on the CUDA
// cores and the bound was 0.2697 ms at 67 TFLOP/s f32.) The tiles waste work
// the count leaves out: the diagonal tiles' upper halves, and the scratch
// (8.4 MB of C B^T, 50 MB of states written and read twice) at the prefill.
#include "ssd_common.cuh"

namespace {

// -- 1. C B^T once for all heads ------------------------------------------------------

constexpr size_t CB_SMEM = (size_t)2 * 2 * T * SA * sizeof(float);

__global__ void __launch_bounds__(THREADS)
ssd_chunk_cb(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ cb,
             int S, int N, int Q, int QP, int nc, Str2 bs, Str2 cs, int bc_vec) {
  extern __shared__ __align__(16) float smem[];   // 2 stages of a C tile then a B tile
  const int ntq = QP / T, pairs = ntq * (ntq + 1) / 2;
  const int pair = blockIdx.x % pairs, c = blockIdx.x / pairs, b = blockIdx.y;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pair) ++qt;
  const int st = pair - qt * (qt + 1) / 2;        // st <= qt: on or below the diagonal
  const int c0 = c * Q, Qv = min(Q, S - c0);
  if (qt * T >= Qv) return;                        // a tile past the end of the last chunk
  const float* cp = Cm + b * cs.b + (long long)(c0 + qt * T) * cs.s;
  const float* bp = Bm + b * bs.b + (long long)(c0 + st * T) * bs.s;
  const int steps = (N + T - 1) / T;
  auto load = [&](int j) {
    float* at = smem + (j & 1) * 2 * T * SA;
    load_tile<T, T, THREADS>(at, SA, cp + j * T, cs.s, Qv - qt * T, N - j * T, bc_vec);
    load_tile<T, T, THREADS>(at + T * SA, SA, bp + j * T, bs.s, Qv - st * T, N - j * T, bc_vec);
  };
  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float acc[8][4];
  zero(acc);
  load(0);
  cp_commit();
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // tile j is in; step j - 1 is done
    if (j + 1 < steps) load(j + 1);                // in flight while tile j is multiplied
    cp_commit();
    const float* at = smem + (j & 1) * 2 * T * SA + 16 * w * SA;
    const float* bt = smem + (j & 1) * 2 * T * SA + T * SA;
    mma3<T, 8>(acc, [&](int half, int k) { return at[(g + 8 * half) * SA + k]; },
               [&](int k, int jj) { return bt[(8 * jj + g) * SA + k]; });
  }
  float* out = cb + (((long long)b * nc + c) * QP + qt * T + 16 * w) * QP + st * T;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(out + (g + 8 * half) * QP + 8 * jj + 2 * t) =
          make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
}

// -- 3. the states entering each chunk -------------------------------------------------

__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decays, int nc, int NPS) {
  const int e = (blockIdx.x * PASS_THREADS + threadIdx.x) * 4;
  if (e >= NPS) return;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  float* base = states + bh * nc * NPS + e;
  const float* dec = decays + bh * nc;
  float4 hv = *reinterpret_cast<const float4*>(base + NPS);         // h_1 = dH_0
  float4 next = *reinterpret_cast<const float4*>(base + 2 * (size_t)NPS);
  for (int c = 2; c < nc; ++c) {
    const float4 d = next;
    if (c + 1 < nc) next = *reinterpret_cast<const float4*>(base + (size_t)(c + 1) * NPS);
    const float a = dec[c];
    hv = make_float4(fmaf(a, hv.x, d.x), fmaf(a, hv.y, d.y), fmaf(a, hv.z, d.z),
                     fmaf(a, hv.w, d.w));
    *reinterpret_cast<float4*>(base + (size_t)c * NPS) = hv;
  }
}

// -- 4. the outputs --------------------------------------------------------------------

__host__ __device__ inline size_t scan_smem(int QP) {
  return (size_t)2 * (T * SA + T * SB) * sizeof(float) + (size_t)QP * sizeof(double) +
         (size_t)(3 * T + QP) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dA,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ states, float* __restrict__ y, int S, int H, int P,
               int N, int Q, int QP, int PS, int nc, Str3 xs, Str3 das, Str2 cs, Str3 ys,
               int x_vec, int bc_vec, int y_vec) {
  extern __shared__ __align__(16) float smem[];   // 2 stages of A [q][k] then B [k][p]
  // cum; then, with r the tile's first row: exp(cum_q) and exp(cum_q - cum_r) of
  // the tile's rows, ones, and exp(cum_r - cum_s) of the positions s before r
  double* cum = reinterpret_cast<double*>(smem + 2 * (T * SA + T * SB));
  float* eq = reinterpret_cast<float*>(cum + QP);
  float* eqr = eq + T;
  float* ones = eqr + T;
  float* esr = ones + T;
  const int nP = (P + T - 1) / T, ntq = QP / T;
  int idx = blockIdx.x;
  const int h = idx % H;
  idx /= H;
  const int pt = idx % nP;
  idx /= nP;
  const int qt = idx % ntq, c = idx / ntq, b = blockIdx.y;
  const int c0 = c * Q, Qv = min(Q, S - c0);
  if (qt * T >= Qv) return;                        // a query tile past the end of the last chunk
  const int PT = min(T, P - pt * T);
  const int n_inter = c > 0 ? (N + T - 1) / T : 0; // C h: steps over N (h_0 = 0)
  const int steps = n_inter + qt + 1;              // then the source tiles 0..qt
  const float* cq = Cm + b * cs.b + (long long)(c0 + qt * T) * cs.s;
  const float* hp = states + (((size_t)b * H + h) * nc + c) * N * PS + pt * T;
  const float* xp = x + b * xs.b + h * xs.h + (long long)c0 * xs.s + pt * T;
  const float* cbp = cb + (((size_t)b * nc + c) * QP + qt * T) * QP;
  auto load = [&](int j) {
    float* at = smem + (j & 1) * (T * SA + T * SB);
    float* bt = at + T * SA;
    if (j < n_inter) {
      load_tile<T, T, THREADS>(at, SA, cq + j * T, cs.s, Qv - qt * T, N - j * T, bc_vec);
      load_tile<T, T, THREADS>(bt, SB, hp + (size_t)j * T * PS, PS, N - j * T, PT, true);
    } else {
      const int st = j - n_inter;
      load_tile<T, T, THREADS>(at, SA, cbp + st * T, QP, T, T, true);
      load_tile<T, T, THREADS>(bt, SB, xp + (long long)st * T * xs.s, xs.s, Qv - st * T, PT,
                               x_vec);
    }
  };
  load(0);
  cp_commit();
  chunk_cumsum(cum, dA + b * das.b + h * das.h + (long long)c0 * das.s, das.s, Qv,
               (qt + 1) * T);
  __syncthreads();
  const double cr = cum[qt * T];
  if (threadIdx.x < T) {
    eq[threadIdx.x] = (float)exp(cum[qt * T + threadIdx.x]);
    eqr[threadIdx.x] = (float)exp(cum[qt * T + threadIdx.x] - cr);
    ones[threadIdx.x] = 1.f;
  }
  for (int s = threadIdx.x; s < qt * T; s += THREADS) esr[s] = (float)exp(cr - cum[s]);

  const int w = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int q0 = qt * T + 16 * w + g;              // this thread's rows q0 and q0 + 8
  const double cq0 = cum[q0], cq1 = cum[q0 + 8];
  float acc[8][4];
  zero(acc);
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();                               // tile j is in; step j - 1 is done
    if (j + 1 < steps) load(j + 1);                // in flight while tile j is multiplied
    cp_commit();
    const float* at = smem + (j & 1) * (T * SA + T * SB) + 16 * w * SA;
    const float* bt = smem + (j & 1) * (T * SA + T * SB) + T * SA;
    auto bfetch = [&](int k, int jj) { return bt[k * SB + 8 * jj + g]; };
    const int r = 16 * w + g;                      // the rows r and r + 8 of the tile
    const int s0 = (j - n_inter) * T;
    if (s0 < qt * T) {
      // C h, its rows weighted by exp(cum_q); or a source tile before the
      // diagonal, exp(cum_q - cum_s) as exp(cum_q - cum_r) exp(cum_r - cum_s),
      // both at most 1: the columns' factor on A, the rows' on the sums
      const bool inter = j < n_inter;
      const float* cf = inter ? ones : esr + s0;
      const float* rf = inter ? eq : eqr;
      mma3<T, 8>(acc, [&](int half, int k) { return at[(g + 8 * half) * SA + k] * cf[k]; },
                 bfetch, rf[r], rf[r + 8]);
    } else {
      mma3<T, 8>(acc, [&](int half, int k) {
                const int s = s0 + k;
                const double cqr = half ? cq1 : cq0;
                const float v = at[(g + 8 * half) * SA + k];
                // exp only on and below the diagonal, where cum_q - cum_s <= 0
                return s <= q0 + 8 * half ? v * expf((float)(cqr - cum[s])) : 0.f;
              }, bfetch);
    }
  }
  float* yp = y + b * ys.b + h * ys.h + pt * T;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + 8 * half;
    if (q >= Qv) continue;
    float* row = yp + (long long)(c0 + q) * ys.s;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = 8 * jj + 2 * t;
      if (y_vec && p + 1 < PT) {
        *reinterpret_cast<float2*>(row + p) = make_float2(acc[jj][2 * half], acc[jj][2 * half + 1]);
      } else {
        if (p < PT) row[p] = acc[jj][2 * half];
        if (p + 1 < PT) row[p + 1] = acc[jj][2 * half + 1];
      }
    }
  }
}

}  // namespace

// Launcher: x (B,H,S,P) and y (B,H,S,P), each given by its pointer and its
// strides over (lane, head, position); dA (B,H,S) likewise; B and C (B,S,N) by
// their strides over (lane, position). The last dim of x, y, B and C is
// contiguous. Chunks of Q positions, nc = ceil(S / Q); 1 <= N <= 128.
// `strides` holds 13 values: x's three, dA's three, B's two, C's two, y's
// three. Scratch, float32, from the caller: cb (B, nc, QP, QP) with QP = Q
// rounded up to 64; states (B, H, nc, N, PS) with PS = P rounded up to 4 and
// decays (B, H, nc), both unused (may be null) when nc == 1; `sizes` holds
// the element counts of cb, states and decays as allocated, and a scratch
// smaller than this layout is refused with cudaErrorInvalidValue before any
// launch. Launches the stages on `stream` (stage 2 only for nc > 1, stage 3
// only for nc > 2) and returns the first cudaGetLastError() that is not success.
extern "C" int launch_ssd_scan_f32(const float* x, const float* dA, const float* Bm,
                                   const float* Cm, float* y, float* cb, float* states,
                                   float* decays, int Bn, int H, int S, int P, int N, int Q,
                                   const long long* st, const long long* sizes, void* stream) {
  if (Bn <= 0 || H <= 0 || S <= 0 || P <= 0 || N <= 0 || N > MAX_N || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const Str3 xs{st[0], st[1], st[2]}, das{st[3], st[4], st[5]}, ys{st[10], st[11], st[12]};
  const Str2 bs{st[6], st[7]}, cs{st[8], st[9]};
  const int nc = (S + Q - 1) / Q, QP = round_up(Q, T), PS = round_up(P, 4);
  const long long chunks = (long long)Bn * nc, heads = nc > 1 ? chunks * H : 0;
  if (sizes[0] < chunks * QP * QP || sizes[1] < heads * N * PS || sizes[2] < heads)
    return (int)cudaErrorInvalidValue;
  const int ntq = QP / T, nP = (P + T - 1) / T;
  const int x_vec = rows_of_16_bytes(x, xs.b, xs.h, xs.s);
  const int bc_vec = rows_of_16_bytes(Bm, bs.b, bs.s, 0) && rows_of_16_bytes(Cm, cs.b, cs.s, 0);
  const int y_vec = reinterpret_cast<uintptr_t>(y) % 8 == 0 && (ys.b | ys.h | ys.s) % 2 == 0;
  const size_t s2 = state_smem(QP), s4 = scan_smem(QP);
  if (s2 > (size_t)SMEM_LIMIT || s4 > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static size_t allowed1 = 48 * 1024, allowed2 = 48 * 1024, allowed4 = 48 * 1024;
  cudaError_t e;
  if ((e = allow_smem(ssd_chunk_cb, CB_SMEM, allowed1)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_chunk_state<false>, s2, allowed2)) != cudaSuccess) return (int)e;
  if ((e = allow_smem(ssd_chunk_scan, s4, allowed4)) != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;

  ssd_chunk_cb<<<dim3(ntq * (ntq + 1) / 2 * nc, Bn), THREADS, CB_SMEM, s>>>(
      Bm, Cm, cb, S, N, Q, QP, nc, bs, cs, bc_vec);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (nc > 1) {
    ssd_chunk_state<false><<<dim3((nc - 1) * nP, H, Bn), STATE_THREADS, s2, s>>>(
        x, dA, Bm, states, decays, S, P, N, Q, QP, PS, nc, xs, das, bs, x_vec, bc_vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (nc > 2) {
    const int NPS = N * PS;
    ssd_state_pass<<<dim3((NPS / 4 + PASS_THREADS - 1) / PASS_THREADS, H, Bn), PASS_THREADS, 0,
                     s>>>(states, decays, nc, NPS);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_chunk_scan<<<dim3(H * nP * ntq * nc, Bn), THREADS, s4, s>>>(
      x, dA, Cm, cb, states, y, S, H, P, N, Q, QP, PS, nc, xs, das, cs, ys, x_vec, bc_vec,
      y_vec);
  return (int)cudaGetLastError();
}
