// The gradient of flash attention (causal / sliding-window / kv_len masks, GQA):
// dQ, dK and dV from Q, K, V, the forward's output O, its row log-sum-exps
// and dO, in three launches.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of the
// plain jnp attention (repro/models/attention.py:63, `flash_attention`, under
// `jax.value_and_grad` in repro/train/steps.py).  On the card the forward is
// K3 (csrc/flash_attention.cu), which writes lse = m + log l of each row when
// asked; this is its backward.  With P = exp(s - lse), s = scale q.k, masked
// pairs P = 0, Delta = rowsum(dO o O) and dS = P o (dP - Delta), the function
// is five products: S = Q K^T and dP = dO V^T (depth D and Dv), dV = P^T dO,
// dK = scale dS^T Q and dQ = scale dS K.  The launches:
//   Delta            one warp a row (`flash_bwd_delta`, both routes);
//   dK and dV        one block per (key tile, KV head, lane): K and V tiles
//                    stay in shared memory; for each query head of the group
//                    and each query tile the masks leave, S and dP are
//                    recomputed, and dV += P^T dO, dK += dS^T Q accumulate in
//                    registers;
//   dQ               one block per (query tile, head, lane): Q and dO stay in
//                    shared memory; over the key tiles the masks leave, S, dP
//                    and dS again, and dQ += dS K in registers.
// Each output element is written by one thread of one block, once: no atomics,
// so a call is deterministic.  A GQA group's dK and dV are summed over its
// query heads inside the block.  S and dP are computed in both passes: seven
// products where five would do, 1.4x the bound's work.
//
// Bound on this card: operations.  The five products take 2 B H (3 D + 2 Dv)
// operations a pair the masks leave; at tinyllama's training shape (B 4,
// S 2048, H 32, D 64, causal) that is 172 GFLOP, 0.174 ms at 989 TFLOP/s bf16,
// against about 150 MB of inputs and outputs, 0.045 ms at 3.35 TB/s.
//
// bfloat16 (`flash_bwd_dkdv_wgmma`, `flash_bwd_dq_wgmma`, templates on the
// head dims <DQK, DV> as the forward's are; built for <16, 16> .. <128, 128>
// and MLA's <192, 128>).  Every product runs on the tensor cores,
// `wgmma.mma_async` m64nNk16 with f32 accumulators.  A block is two
// warpgroups, 256 threads, with up to 255 registers each (a ninth, producer
// warp made ptxas give every thread 168, and <128, 128> spilled: three warps
// then share one of the SM's four register files).  Warp 0 loads the tile
// that stays by TMA and keeps a ring of three or four stages two tiles ahead
// (below); the stages complete on mbarriers and go back to it when each warp
// has arrived.
//   dK, dV: a block holds 128 keys (64 a warpgroup) and streams (Q, dO)
//   tiles of BQ query rows with their lse and Delta, which warp 0's lanes
//   copy in by `cp.async` (zeros past Sq) beside the TMA loads; the copies
//   arrive on the stage's barrier when they land, so warp 0 never waits on
//   them.  Per stage
//   S^T = K Q^T and dP^T = V dO^T take A (K or V) and B (Q or dO) K-major
//   from shared memory; P^T and dS^T are formed in registers on exp2, and
//   their f32 fragments, rounded to bf16 pairs in place, are the A fragments
//   of dV += P^T dO and dK += dS^T Q, which read dO and Q N-major through the
//   transpose bit (as the forward reads V).  So Q and dO are read both ways
//   from one swizzled copy.  The masks are transposed here (rows are keys):
//   each key row's bounds on its query columns are tested only in tiles a
//   mask reaches, and query columns at or past Sq are masked, not left to
//   TMA's zero fill.  BQ is 64 where dK, dV, S^T and dP^T fit (DQK + DV)/2 +
//   BQ <= 192 accumulators a thread, else 32 (m64n32 products): <192, 128>.
//   dQ: a block holds 128 query rows (64 a warpgroup) and streams
//   (K, V) tiles of 64 keys; each thread keeps its two rows' lse and Delta
//   in registers; dQ += dS K reads K N-major (n192 at MLA's DQK).  At DQK
//   <= 64 two blocks share an SM.
// The roundings beyond the plain version's are P^T and dS^T (and dS) to bf16
// before the three products that take them, as SDPA's backward rounds.
//
// Logit soft-capping (the forward's cap c): P is rebuilt from the capped
// scores, P = exp(c t - lse) with t = tanh(s / c), and dS takes the cap's
// derivative, dS = P o (dP - Delta) o (1 - t^2); dQ and dK stay scale dS K and
// scale dS^T Q.  Every kernel but `flash_bwd_delta` is a template on CAP
// beside a runtime `cap`, so the uncapped instantiations are the code they
// were; t is formed beside P and used at once, never kept across a product.
// The wgmma kernels take `tanh.approx.f32`, the CUDA cores tanhf.  Both passes
// form P, so a capped pair costs this design four special functions (two
// exp2, two tanh), where the gradient needs two, as the forward does.  No
// capped <192, 128> is built (MLA ignores the cap).
//
// The CUDA cores (`flash_bwd_dkdv`, `flash_bwd_dq`: one template over the
// storage type, float32 arithmetic): float32 at every head dim (TF32 could
// not meet its 1e-4 check), and bfloat16 at head dim 256, where the wgmma
// blocks' dK and dV accumulators would not fit a warpgroup's registers.  The
// S and dP products read rows of Q, dO, K and V along D as float4 from tiles
// padded by 4 floats (free of bank conflicts), and the output products read
// one row of dS or P per step, broadcast.
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;       // a 16 x 16 grid of threads over each tile
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;               // in elements; the head dim is contiguous
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Tiles of head dim D: BQ query rows, BK keys, rows of DP floats (D + 4, so a
// float4 read of 8 lanes on 8 rows hits 32 distinct banks), P and dS rows of
// PP floats.  Thread (tx, ty) = (tid % 16, tid / 16) owns the scores of rows
// ty + 16a and keys tx + 16c, and the output dims tx + 16c.
template <int D>
struct Bwd {
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int DP = D + 4;
  static constexpr int PP = BK + 1;
  static constexpr int MI = BQ / 16;          // score rows a thread
  static constexpr int MJ = BK / 16;          // score columns a thread
  static constexpr int MD = D / 16;           // output dims a thread
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)(2 * BK * DP + 2 * BQ * DP + 2 * BQ * PP + 2 * BQ);
  static_assert(SMEM <= SMEM_LIMIT, "the tiles do not fit a block's shared memory");
};

__device__ __forceinline__ bool visible(int i, int j, int Sq, int kv_len, int causal,
                                        int window) {
  return i < Sq && j < kv_len && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// rows r0.. of a strided (rows, D) matrix into a (R, DP) float tile; rows at or
// past n are zeros
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int r0,
                                          int n) {
  for (int e = threadIdx.x; e < R * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 4) + c] = r0 + r < n ? to_f(src[(long long)(r0 + r) * row_stride + c]) : 0.f;
  }
}

// s = A B^T and dp = dA dB^T over D for the thread's MI x MJ scores: rows of
// A and dA from `a`, `da` (BQ rows), of B and dB from `b`, `db` (BK rows)
template <int D>
__device__ __forceinline__ void two_scores(const float* a, const float* da, const float* b,
                                           const float* db, int tx, int ty,
                                           float (&s)[Bwd<D>::MI][Bwd<D>::MJ],
                                           float (&dp)[Bwd<D>::MI][Bwd<D>::MJ]) {
  using P = Bwd<D>;
#pragma unroll
  for (int x = 0; x < P::MI; ++x)
#pragma unroll
    for (int y = 0; y < P::MJ; ++y) s[x][y] = dp[x][y] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qa[P::MI], ga[P::MI], kb[P::MJ], vb[P::MJ];
#pragma unroll
    for (int x = 0; x < P::MI; ++x) {
      qa[x] = *reinterpret_cast<const float4*>(a + (ty + 16 * x) * P::DP + d);
      ga[x] = *reinterpret_cast<const float4*>(da + (ty + 16 * x) * P::DP + d);
    }
#pragma unroll
    for (int y = 0; y < P::MJ; ++y) {
      kb[y] = *reinterpret_cast<const float4*>(b + (tx + 16 * y) * P::DP + d);
      vb[y] = *reinterpret_cast<const float4*>(db + (tx + 16 * y) * P::DP + d);
    }
#pragma unroll
    for (int x = 0; x < P::MI; ++x)
#pragma unroll
      for (int y = 0; y < P::MJ; ++y) {
        s[x][y] = fmaf(qa[x].w, kb[y].w, fmaf(qa[x].z, kb[y].z,
                  fmaf(qa[x].y, kb[y].y, fmaf(qa[x].x, kb[y].x, s[x][y]))));
        dp[x][y] = fmaf(ga[x].w, vb[y].w, fmaf(ga[x].z, vb[y].z,
                   fmaf(ga[x].y, vb[y].y, fmaf(ga[x].x, vb[y].x, dp[x][y]))));
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                int H, int Sq, int D, Strides os, Strides dos, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / Sq / H);
  const T* orow = o + b * os.b + h * os.h + (long long)i * os.s;
  const T* grow = dout + b * dos.b + h * dos.h + (long long)i * dos.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(grow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// P = exp(s - lse) of a scaled score s (capped to c t, t = tanh(s / c),
// under CAP), 0 where no mask lets the pair through; `dcap` takes the cap's
// derivative 1 - t^2
template <bool CAP>
__device__ __forceinline__ float bwd_p(float s, float lse, float cap, bool visible, float& dcap) {
  if constexpr (CAP) {
    const float t = tanhf(s / cap);
    dcap = 1.f - t * t;
    s = t * cap;
  }
  return visible ? expf(s - lse) : 0.f;
}

template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int group, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides dos,
               Strides dks, Strides dvs, float scale, int causal, int window, int kv_len,
               float cap) {
  using P = Bwd<D>;
  constexpr int BQ = P::BQ, BK = P::BK, DP = P::DP, PP = P::PP;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // (BK, DP)
  float* vt = kt + BK * DP;                      // (BK, DP)
  float* qt = vt + BK * DP;                      // (BQ, DP)
  float* gt = qt + BQ * DP;                      // (BQ, DP) dO
  float* pt = gt + BQ * DP;                      // (BQ, PP) P
  float* st = pt + BQ * PP;                      // (BQ, PP) dS
  float* lt = st + BQ * PP;                      // (BQ) lse
  float* et = lt + BQ;                           // (BQ) Delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BK;                // under a causal mask the first tiles are longest
  const int kvh = blockIdx.y, b = blockIdx.z;
  load_tile<T, BK, D>(kt, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
  load_tile<T, BK, D>(vt, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);

  float adk[P::MJ][P::MD], adv[P::MJ][P::MD];
#pragma unroll
  for (int x = 0; x < P::MJ; ++x)
#pragma unroll
    for (int y = 0; y < P::MD; ++y) adk[x][y] = adv[x][y] = 0.f;

  // the query rows that see a key of this tile: from k0 on under a causal
  // mask, before k0 + BK - 1 + window under a window, none past kv_len
  int q_begin = causal ? k0 / BQ * BQ : 0;
  int q_end = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  if (k0 >= kv_len) q_end = 0;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* delta_h = delta + ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();                           // the previous tiles are consumed
      load_tile<T, BQ, D>(qt, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
      load_tile<T, BQ, D>(gt, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        lt[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
        et[r] = q0 + r < Sq ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[P::MI][P::MJ], dp[P::MI][P::MJ];
      two_scores<D>(qt, gt, kt, vt, tx, ty, s, dp);
#pragma unroll
      for (int x = 0; x < P::MI; ++x) {
        const int r = ty + 16 * x;
#pragma unroll
        for (int y = 0; y < P::MJ; ++y) {
          const int c = tx + 16 * y;
          float dcap;
          const float p = bwd_p<CAP>(s[x][y] * scale, lt[r], cap,
                                     visible(q0 + r, k0 + c, Sq, kv_len, causal, window), dcap);
          pt[r * PP + c] = p;
          st[r * PP + c] = CAP ? p * (dp[x][y] - et[r]) * dcap : p * (dp[x][y] - et[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's query rows
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pr[P::MJ], sr[P::MJ], gv[P::MD], qv[P::MD];
#pragma unroll
        for (int x = 0; x < P::MJ; ++x) {
          pr[x] = pt[i * PP + ty + 16 * x];
          sr[x] = st[i * PP + ty + 16 * x];
        }
#pragma unroll
        for (int y = 0; y < P::MD; ++y) {
          gv[y] = gt[i * DP + tx + 16 * y];
          qv[y] = qt[i * DP + tx + 16 * y];
        }
#pragma unroll
        for (int x = 0; x < P::MJ; ++x)
#pragma unroll
          for (int y = 0; y < P::MD; ++y) {
            adv[x][y] = fmaf(pr[x], gv[y], adv[x][y]);
            adk[x][y] = fmaf(sr[x], qv[y], adk[x][y]);
          }
      }
    }
  }

  T* dkp = dk + b * dks.b + kvh * dks.h;
  T* dvp = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int x = 0; x < P::MJ; ++x) {
    const int j = k0 + ty + 16 * x;
    if (j >= Sk) continue;
#pragma unroll
    for (int y = 0; y < P::MD; ++y) {
      const int d = tx + 16 * y;
      dkp[(long long)j * dks.s + d] = from_f<T>(adk[x][y] * scale);
      dvp[(long long)j * dvs.s + d] = from_f<T>(adv[x][y]);
    }
  }
}

template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int group, int Sq, int Sk,
             Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
             int causal, int window, int kv_len, float cap) {
  using P = Bwd<D>;
  constexpr int BQ = P::BQ, BK = P::BK, DP = P::DP, PP = P::PP;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // (BQ, DP)
  float* gt = qt + BQ * DP;                      // (BQ, DP) dO
  float* kt = gt + BQ * DP;                      // (BK, DP)
  float* vt = kt + BK * DP;                      // (BK, DP)
  float* st = vt + BK * DP;                      // (BQ, PP) dS
  float* lt = st + BQ * PP;                      // (BQ) lse
  float* et = lt + BQ;                           // (BQ) Delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // last query tiles first: under a causal mask they have the most key tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  load_tile<T, BQ, D>(qt, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<T, BQ, D>(gt, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  const long long row0 = ((long long)b * gridDim.y + h) * Sq;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    lt[r] = q0 + r < Sq ? lse[row0 + q0 + r] : 0.f;
    et[r] = q0 + r < Sq ? delta[row0 + q0 + r] : 0.f;
  }

  float adq[P::MI][P::MD];
#pragma unroll
  for (int x = 0; x < P::MI; ++x)
#pragma unroll
    for (int y = 0; y < P::MD; ++y) adq[x][y] = 0.f;

  // the forward's bounds: stop at the block's diagonal, start at the first
  // tile a row's window reaches, nothing at or past kv_len
  const int kv_end = min(causal ? min(Sk, q0 + BQ) : Sk, kv_len);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();                             // the previous tiles are consumed
    load_tile<T, BK, D>(kt, k + b * ks.b + kvh * ks.h, ks.s, k0, Sk);
    load_tile<T, BK, D>(vt, v + b * vs.b + kvh * vs.h, vs.s, k0, Sk);
    __syncthreads();

    float s[P::MI][P::MJ], dp[P::MI][P::MJ];
    two_scores<D>(qt, gt, kt, vt, tx, ty, s, dp);
#pragma unroll
    for (int x = 0; x < P::MI; ++x) {
      const int r = ty + 16 * x;
#pragma unroll
      for (int y = 0; y < P::MJ; ++y) {
        const int c = tx + 16 * y;
        float dcap;
        const float p = bwd_p<CAP>(s[x][y] * scale, lt[r], cap,
                                   visible(q0 + r, k0 + c, Sq, kv_len, causal, window), dcap);
        st[r * PP + c] = CAP ? p * (dp[x][y] - et[r]) * dcap : p * (dp[x][y] - et[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sr[P::MI], kv[P::MD];
#pragma unroll
      for (int x = 0; x < P::MI; ++x) sr[x] = st[(ty + 16 * x) * PP + j];
#pragma unroll
      for (int y = 0; y < P::MD; ++y) kv[y] = kt[j * DP + tx + 16 * y];
#pragma unroll
      for (int x = 0; x < P::MI; ++x)
#pragma unroll
        for (int y = 0; y < P::MD; ++y) adq[x][y] = fmaf(sr[x], kv[y], adq[x][y]);
    }
  }

  T* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int x = 0; x < P::MI; ++x) {
    const int i = q0 + ty + 16 * x;
    if (i >= Sq) continue;
#pragma unroll
    for (int y = 0; y < P::MD; ++y)
      dqp[(long long)i * dqs.s + tx + 16 * y] = from_f<T>(adq[x][y] * scale);
  }
}

template <typename F>
int allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int D, bool CAP>
int launch_d(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse,
             float* delta, T* dq, T* dk, T* dv, int B, int H, int KvH, int Sq, int Sk,
             const long long* st, float scale, int causal, int window, int kv_len, float cap,
             cudaStream_t stream) {
  using P = Bwd<D>;
  static bool attribute_set = false;           // once per instantiation
  if (!attribute_set) {
    int e = allow_smem(flash_bwd_dkdv<T, D, CAP>, P::SMEM);
    if (!e) e = allow_smem(flash_bwd_dq<T, D, CAP>, P::SMEM);
    if (e) return e;
    attribute_set = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]};
  const Strides os{st[9], st[10], st[11]}, dos{st[12], st[13], st[14]};
  const Strides dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]};
  const Strides dvs{st[21], st[22], st[23]};
  const long long rows = (long long)B * H * Sq;
  const int per_block = THREADS / 32;
  flash_bwd_delta<T><<<(unsigned)((rows + per_block - 1) / per_block), THREADS, 0, stream>>>(
      o, dout, delta, H, Sq, D, os, dos, rows);
  int e = (int)cudaGetLastError();
  if (e) return e;
  flash_bwd_dkdv<T, D, CAP><<<dim3((Sk + P::BK - 1) / P::BK, KvH, B), THREADS, P::SMEM,
                              stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, H / KvH, Sq, Sk, qs, ks, vs, dos, dks, dvs, scale,
      causal, window, kv_len, cap);
  e = (int)cudaGetLastError();
  if (e) return e;
  flash_bwd_dq<T, D, CAP><<<dim3((Sq + P::BQ - 1) / P::BQ, H, B), THREADS, P::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, H / KvH, Sq, Sk, qs, ks, vs, dos, dqs, scale, causal,
      window, kv_len, cap);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int KvH, int Sq, int Sk, int kv_len) {
  return B <= 0 || H <= 0 || KvH <= 0 || H % KvH || Sq <= 0 || Sk <= 0 || kv_len <= 0 ||
         kv_len > Sk;
}

// float32 at any head dim; bfloat16 at 256 only (below it the tensor cores)
template <typename T, bool CAP>
int launch_any(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
               int KvH, int Sq, int Sk, int D, const long long* st, float scale, int causal,
               int window, int kv_len, float cap, cudaStream_t s) {
  if (bad_shape(B, H, KvH, Sq, Sk, kv_len)) return (int)cudaErrorInvalidValue;
  // the float4 reads of the tiles come from shared memory, so the operands'
  // rows need no alignment here
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v, *to = (const T*)o;
  const T* tg = (const T*)dout;
  T *gq = (T*)dq, *gk = (T*)dk, *gv = (T*)dv;
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 16: return launch_d<T, 16, CAP>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
      case 32: return launch_d<T, 32, CAP>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
      case 64: return launch_d<T, 64, CAP>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
      case 128: return launch_d<T, 128, CAP>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    }
  }
  if (D == 256)
    return launch_d<T, 256, CAP>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_any_cap(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KvH, int Sq, int Sk, int D, const long long* st, float scale, int causal,
                   int window, int kv_len, float cap, cudaStream_t s) {
  if (cap < 0.f) return (int)cudaErrorInvalidValue;
  if (cap > 0.f)
    return launch_any<T, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, D, st, scale, causal, window, kv_len, cap, s);
  return launch_any<T, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, D, st, scale, causal, window, kv_len, cap, s);
}

// -- bfloat16 on the tensor cores ---------------------------------------------------

// The tiles of both passes for head dims DQK (Q, K) and DV (V, O).
template <int DQK, int DV>
struct BwdTile {
  static_assert(DQK == DV || (DQK % 64 == 0 && DV % 64 == 0),
                "head dims that differ must both be whole 128-byte boxes");
  static constexpr int THREADS = 256;     // two consumer warpgroups
  static constexpr int STAGES = 3;
  static constexpr int SWZ = DQK >= 64 ? 128 : DQK * 2;   // bytes of a box row, its swizzle
  static constexpr int COLS = SWZ / 2;                    // head dims a box
  static constexpr int QK_BOXES = DQK / COLS, V_BOXES = DV / COLS;
  // dK, dV: KK keys a block that stay, query tiles of KQ rows in the ring
  static constexpr int KK = 128;
  static constexpr int KQ = (DQK + DV) / 2 + 64 <= 192 ? 64 : 32;
  static constexpr int K_TILE = KK * DQK * 2, V_TILE = KK * DV * 2;
  static constexpr int KQ_Q = KQ * DQK * 2;               // Q's bytes in a stage
  static constexpr int KQ_STAGE = KQ_Q + KQ * DV * 2;     // and dO's
  // slack to align to 1 KB, K, V, the ring with each stage's lse and Delta,
  // barriers
  static constexpr int DKDV_SMEM =
      1024 + K_TILE + V_TILE + STAGES * (KQ_STAGE + 2 * KQ * 4) + 64;
  // dQ: QQ query rows a block that stay, key tiles of QK keys in the ring
  static constexpr int QQ = 128, QK = 64;
  static constexpr int Q_TILE = QQ * DQK * 2, DO_TILE = QQ * DV * 2;
  static constexpr int QK_K = QK * DQK * 2;               // K's bytes in a stage
  static constexpr int QK_STAGE = QK_K + QK * DV * 2;     // and V's
  static constexpr int DQ_SMEM = 1024 + Q_TILE + DO_TILE + STAGES * QK_STAGE + 64;
  static_assert(DKDV_SMEM <= SMEM_LIMIT && DQ_SMEM <= SMEM_LIMIT,
                "the tiles do not fit a block's shared memory");
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&pair);
}

// Accumulator i of a consumer thread (warp w of its warpgroup, lane l) is row
// w*16 + l/4 + 8*((i/2)%2), column 8*(i/4) + 2*(l%4) + i%2 of its 64-row tile;
// the fragments of k16 step kk of an A operand from registers are the
// accumulators 8kk + {0,1}, {2,3}, {4,5}, {6,7}, rounded to bf16 pairs.
//
// Loads: warp 0 keeps the ring STAGES - 1 tiles ahead of the tile it works
// on.  Before tile t it fills the stage of tile t + STAGES - 1, once every
// warp has arrived on that stage's `empty` barrier after tile t - 1, and the
// stage's `full` barrier completes when its bytes have landed.

// P = exp2(s qk_mul - lse log2(e)) from a raw product s and its row's lse,
// qk_mul = scale log2(e); under CAP, with qk_mul = scale / c,
// P = exp2(t cap_log2 - lse log2(e)), t = tanh(s qk_mul), cap_log2 = c log2(e),
// and `dcap` takes the cap's derivative 1 - t^2
template <bool CAP>
__device__ __forceinline__ float bwd_p2(float s, float lse_log2, float qk_mul, float cap_log2,
                                        float& dcap) {
  if constexpr (CAP) {
    const float t = tanh_approx(s * qk_mul);
    dcap = 1.f - t * t;
    return exp2f(fmaf(t, cap_log2, -lse_log2));
  }
  return exp2f(fmaf(s, qk_mul, -lse_log2));
}

template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(BwdTile<DQK, DV>::THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, MapDims mq, MapDims mk,
                     MapDims mv, MapDims mdo, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Strides dks, Strides dvs, int H, int group,
                     int Sq, int Sk, float scale, float qk_mul, int causal, int window,
                     int kv_len, float cap_log2) {
  using T = BwdTile<DQK, DV>;
  constexpr int SWZ = T::SWZ, COLS = T::COLS, KK = T::KK, BQ = T::KQ, STAGES = T::STAGES;
  constexpr int AHEAD = STAGES - 1;
  extern __shared__ __align__(1024) uint8_t fsm[];
  const uint32_t base = (smem_u32(fsm) + 1023u) & ~1023u;
  const uint32_t k_sm = base, v_sm = k_sm + T::K_TILE, ring = v_sm + T::V_TILE;
  // (STAGES, 2, BQ) floats: each stage's rows' lse, then their Delta
  const uint32_t lsd_sm = ring + STAGES * T::KQ_STAGE;
  const float* lsd = reinterpret_cast<const float*>(fsm + (lsd_sm - smem_u32(fsm)));
  const uint32_t kv_full = lsd_sm + STAGES * 2 * BQ * 4;
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  // the key tiles are the grid's slowest dim, first tiles first: under a
  // causal mask they have the most query tiles
  const int k0 = blockIdx.z * KK;
  const int kvh = blockIdx.x, b = blockIdx.y;
  // the query rows that see a key of this tile: from k0 on under a causal
  // mask, before k0 + KK - 1 + window under a window, none past kv_len
  const int q_begin = causal ? k0 / BQ * BQ : 0;
  const int q_end = k0 >= kv_len ? q_begin : window > 0 ? min(Sq, k0 + KK - 1 + window) : Sq;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int tiles = group * n_qt;                 // (query head, query tile), heads outer

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 33);               // lane 0's expect_tx, warp 0's 32 cp.asyncs
      mbar_init(empty + 8 * s, 8);               // one arrival from each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t's stage: Q and dO by TMA (lane 0), lse and Delta by cp.async
  // (zeros past Sq), all completing on the stage's full barrier
  auto produce = [&](int t) {
    const int s = t % STAGES, h = kvh * group + t / n_qt, q0 = q_begin + t % n_qt * BQ;
    if (t >= STAGES) mbar_wait(empty + 8 * s, ((t / STAGES) - 1) & 1);
    const uint32_t bar = full + 8 * s, q_st = ring + s * T::KQ_STAGE, do_st = q_st + T::KQ_Q;
    if (l == 0) {
      mbar_expect_tx(bar, T::KQ_STAGE);
      for (int j = 0; j < T::QK_BOXES; ++j)
        tma_load_bhsd(q_st + j * BQ * SWZ, &tq, mq, j * COLS, h, q0, b, bar);
      for (int j = 0; j < T::V_BOXES; ++j)
        tma_load_bhsd(do_st + j * BQ * SWZ, &tdo, mdo, j * COLS, h, q0, b, bar);
    }
    const long long row0 = ((long long)b * H + h) * Sq;
    const uint32_t ls = lsd_sm + s * 2 * BQ * 4;
    for (int r = l; r < BQ; r += 32) {
      const bool in = q0 + r < Sq;
      const long long at = row0 + (in ? q0 + r : 0);
      cp_async4(ls + r * 4, lse + at, in ? 4 : 0);
      cp_async4(ls + (BQ + r) * 4, delta + at, in ? 4 : 0);
    }
    mbar_arrive_cp_async(bar);
  };

  if (warp == 0) {
    if (l == 0) {
      mbar_expect_tx(kv_full, T::K_TILE + T::V_TILE);
      for (int j = 0; j < T::QK_BOXES; ++j)
        tma_load_bhsd(k_sm + j * KK * SWZ, &tk, mk, j * COLS, kvh, k0, b, kv_full);
      for (int j = 0; j < T::V_BOXES; ++j)
        tma_load_bhsd(v_sm + j * KK * SWZ, &tv, mv, j * COLS, kvh, k0, b, kv_full);
    }
    for (int t = 0; t < AHEAD && t < tiles; ++t) produce(t);
  }

  // consumer warpgroup wg: keys kw0 .. kw0 + 63, as the rows of S^T
  const int wg = warp / 4, w = warp % 4;
  const int kw0 = k0 + wg * 64;
  const int krow = kw0 + w * 16 + l / 4;           // this thread's keys: krow, krow + 8
  const uint32_t k_wg = k_sm + wg * 64 * SWZ, v_wg = v_sm + wg * 64 * SWZ;
  float adk[DQK / 2], adv[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) adk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) adv[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int t = 0; t < tiles; ++t) {
    if (warp == 0 && t + AHEAD < tiles) produce(t + AHEAD);
    __syncwarp();
    const int s = t % STAGES, q0 = q_begin + t % n_qt * BQ;
    const uint32_t q_st = ring + s * T::KQ_STAGE, do_st = q_st + T::KQ_Q;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    // a tile no pair of which this warpgroup's keys see is passed by
    const bool none = kw0 >= kv_len || (causal && q0 + BQ - 1 < kw0) ||
                      (window > 0 && q0 >= kw0 + 63 + window);
    if (!none) {
      // S^T = K Q^T and dP^T = V dO^T: k16 step kk lies in box kk*16/COLS
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t in_box = kk * 16 / COLS, off = (kk * 16 % COLS) * 2;
        wgmma_ss<BQ>(st, smem_desc(k_wg + in_box * KK * SWZ + off, 16, 8 * SWZ, SWZ),
                     smem_desc(q_st + in_box * BQ * SWZ + off, 16, 8 * SWZ, SWZ), 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t in_box = kk * 16 / COLS, off = (kk * 16 % COLS) * 2;
        wgmma_ss<BQ>(dpt, smem_desc(v_wg + in_box * KK * SWZ + off, 16, 8 * SWZ, SWZ),
                     smem_desc(do_st + in_box * BQ * SWZ + off, 16, 8 * SWZ, SWZ), 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // P^T and dS^T.  Masks only where one reaches this tile: key row r
      // sees the query columns lo[r] .. hi[r], relative to this thread's
      // first column q0 + 2*(l%4)
      const float* ls = lsd + s * 2 * BQ;
      const bool edge = q0 + BQ > Sq || kw0 + 64 > kv_len || (causal && q0 < kw0 + 63) ||
                        (window > 0 && q0 + BQ - 1 >= kw0 + window);
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = krow + 8 * r, qcol = q0 + 2 * (l % 4);
        lo[r] = (causal ? kpos : 0) - qcol;
        hi[r] = (kpos >= kv_len ? -1 : window > 0 ? min(Sq - 1, kpos + window - 1) : Sq - 1) -
                qcol;
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = kk * 8 + j * 2, r = j & 1, c = 8 * (i >> 2);
          const float2 lq = *reinterpret_cast<const float2*>(ls + c + 2 * (l % 4));
          const float2 dl = *reinterpret_cast<const float2*>(ls + BQ + c + 2 * (l % 4));
          float d0, d1;
          float p0 = bwd_p2<CAP>(st[i], lq.x * LOG2E, qk_mul, cap_log2, d0);
          float p1 = bwd_p2<CAP>(st[i + 1], lq.y * LOG2E, qk_mul, cap_log2, d1);
          if (edge) {
            p0 = c >= lo[r] && c <= hi[r] ? p0 : 0.f;
            p1 = c + 1 >= lo[r] && c + 1 <= hi[r] ? p1 : 0.f;
          }
          pa[kk][j] = bf16_pair(p0, p1);
          da[kk][j] = CAP ? bf16_pair(p0 * (dpt[i] - dl.x) * d0, p1 * (dpt[i + 1] - dl.y) * d1)
                          : bf16_pair(p0 * (dpt[i] - dl.x), p1 * (dpt[i + 1] - dl.y));
        }

      // dV += P^T dO, dK += dS^T Q: dO and Q are (query rows, dims), N-major;
      // k16 step kk is 16 rows down, the boxes of COLS dims BQ*SWZ bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DV>(adv, pa[kk], smem_desc(do_st + kk * 16 * SWZ, BQ * SWZ, 8 * SWZ, SWZ));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DQK>(adk, da[kk], smem_desc(q_st + kk * 16 * SWZ, BQ * SWZ, 8 * SWZ, SWZ));
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (l == 0) mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* dkp = dk + b * dks.b + kvh * dks.h;
  __nv_bfloat16* dvp = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow + 8 * r;
    if (key >= Sk) continue;
    __nv_bfloat16* krow_k = dkp + (long long)key * dks.s + 2 * (l % 4);
    __nv_bfloat16* krow_v = dvp + (long long)key * dvs.s + 2 * (l % 4);
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(krow_k + 8 * j) =
          __floats2bfloat162_rn(adk[4 * j + 2 * r] * scale, adk[4 * j + 2 * r + 1] * scale);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(krow_v + 8 * j) =
          __floats2bfloat162_rn(adv[4 * j + 2 * r], adv[4 * j + 2 * r + 1]);
  }
}

// Two blocks an SM at DQK <= 64 (128 registers a thread; the four warpgroups
// hide each other's exp and wait), one above.
template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(BwdTile<DQK, DV>::THREADS, DQK <= 64 ? 2 : 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, MapDims mq, MapDims mk, MapDims mv,
                   MapDims mdo, const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, Strides dqs, int H, int group, int Sq, int Sk,
                   float scale, float qk_mul, int causal, int window, int kv_len,
                   float cap_log2) {
  using T = BwdTile<DQK, DV>;
  constexpr int SWZ = T::SWZ, COLS = T::COLS, BQ = T::QQ, TK = T::QK, STAGES = T::STAGES;
  constexpr int AHEAD = STAGES - 1;
  extern __shared__ __align__(1024) uint8_t fsm[];
  const uint32_t base = (smem_u32(fsm) + 1023u) & ~1023u;
  const uint32_t q_sm = base, do_sm = q_sm + T::Q_TILE, ring = do_sm + T::DO_TILE;
  const uint32_t q_full = ring + STAGES * T::QK_STAGE;
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  // the query tiles are the grid's slowest dim, last tiles first: under a
  // causal mask they have the most key tiles
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / group;
  // the forward's bounds: stop at the block's diagonal, start at the first
  // tile a row's window reaches, nothing at or past kv_len
  const int kv_end = min(causal ? min(Sk, q0 + BQ) : Sk, kv_len);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / TK * TK : 0;
  const int tiles = kv_end > kv_begin ? (kv_end - kv_begin + TK - 1) / TK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);               // one arrival from each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t's stage: K and V by TMA
  auto produce = [&](int t) {
    const int s = t % STAGES;
    if (t >= STAGES) mbar_wait(empty + 8 * s, ((t / STAGES) - 1) & 1);
    const uint32_t bar = full + 8 * s, k_st = ring + s * T::QK_STAGE, v_st = k_st + T::QK_K;
    mbar_expect_tx(bar, T::QK_STAGE);
    const int k0 = kv_begin + t * TK;
    for (int j = 0; j < T::QK_BOXES; ++j)
      tma_load_bhsd(k_st + j * TK * SWZ, &tk, mk, j * COLS, kvh, k0, b, bar);
    for (int j = 0; j < T::V_BOXES; ++j)
      tma_load_bhsd(v_st + j * TK * SWZ, &tv, mv, j * COLS, kvh, k0, b, bar);
  };

  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, T::Q_TILE + T::DO_TILE);
    for (int j = 0; j < T::QK_BOXES; ++j)
      tma_load_bhsd(q_sm + j * BQ * SWZ, &tq, mq, j * COLS, h, q0, b, q_full);
    for (int j = 0; j < T::V_BOXES; ++j)
      tma_load_bhsd(do_sm + j * BQ * SWZ, &tdo, mdo, j * COLS, h, q0, b, q_full);
    for (int t = 0; t < AHEAD && t < tiles; ++t) produce(t);
  }

  // consumer warpgroup wg: query rows wq0 .. wq0 + 63
  const int wg = warp / 4, w = warp % 4;
  const int wq0 = q0 + wg * 64;
  const int row0 = wq0 + w * 16 + l / 4;           // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = q_sm + wg * 64 * SWZ, do_wg = do_sm + wg * 64 * SWZ;
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + row;
    lq[r] = row < Sq ? lse[at] * LOG2E : 0.f;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }
  float adq[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) adq[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int t = 0; t < tiles; ++t) {
    if (threadIdx.x == 0 && t + AHEAD < tiles) produce(t + AHEAD);
    __syncwarp();
    const int s = t % STAGES, k0 = kv_begin + t * TK;
    const uint32_t k_st = ring + s * T::QK_STAGE, v_st = k_st + T::QK_K;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    // a tile none of whose keys this warpgroup's rows see is passed by
    const bool none = wq0 >= Sq || (causal && k0 > wq0 + 63) ||
                      (window > 0 && k0 + TK - 1 <= wq0 - window);
    if (!none) {
      float sc[TK / 2], dp[TK / 2];
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t in_box = kk * 16 / COLS, off = (kk * 16 % COLS) * 2;
        wgmma_ss<TK>(sc, smem_desc(q_wg + in_box * BQ * SWZ + off, 16, 8 * SWZ, SWZ),
                     smem_desc(k_st + in_box * TK * SWZ + off, 16, 8 * SWZ, SWZ), 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t in_box = kk * 16 / COLS, off = (kk * 16 % COLS) * 2;
        wgmma_ss<TK>(dp, smem_desc(do_wg + in_box * BQ * SWZ + off, 16, 8 * SWZ, SWZ),
                     smem_desc(v_st + in_box * TK * SWZ + off, 16, 8 * SWZ, SWZ), 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // P and dS; masks as the forward's, against each row's bounds
      // relative to this thread's first column k0 + 2*(l%4)
      const bool edge = k0 + TK > kv_len || (causal && k0 + TK - 1 > wq0) ||
                        (window > 0 && k0 <= wq0 + 63 - window);
      const int base_col = k0 + 2 * (l % 4);
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + 8 * r;
        hi[r] = (causal ? min(kv_len - 1, qpos) : kv_len - 1) - base_col;
        lo[r] = window > 0 ? qpos - window + 1 - base_col : -TK;
      }
      uint32_t da[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = kk * 8 + j * 2, r = j & 1, c = 8 * (i >> 2);
          float d0, d1;
          float p0 = bwd_p2<CAP>(sc[i], lq[r], qk_mul, cap_log2, d0);
          float p1 = bwd_p2<CAP>(sc[i + 1], lq[r], qk_mul, cap_log2, d1);
          if (edge) {
            p0 = c >= lo[r] && c <= hi[r] ? p0 : 0.f;
            p1 = c + 1 >= lo[r] && c + 1 <= hi[r] ? p1 : 0.f;
          }
          da[kk][j] = CAP ? bf16_pair(p0 * (dp[i] - dl[r]) * d0, p1 * (dp[i + 1] - dl[r]) * d1)
                          : bf16_pair(p0 * (dp[i] - dl[r]), p1 * (dp[i + 1] - dl[r]));
        }

      // dQ += dS K: K is (keys, DQK), N-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<DQK>(adq, da[kk], smem_desc(k_st + kk * 16 * SWZ, TK * SWZ, 8 * SWZ, SWZ));
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (l == 0) mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* qrow = dqp + (long long)row * dqs.s + 2 * (l % 4);
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) =
          __floats2bfloat162_rn(adq[4 * j + 2 * r] * scale, adq[4 * j + 2 * r + 1] * scale);
  }
}

template <int DQK, int DV, bool CAP>
int launch_wgmma_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KvH, int Sq, int Sk, const long long* st, float scale, int causal,
                   int window, int kv_len, float cap, cudaStream_t stream) {
  using T = BwdTile<DQK, DV>;
  // the dK/dV pass reads Q and dO in boxes of KQ rows, K and V of KK; the dQ
  // pass Q and dO of QQ rows, K and V of QK
  CUtensorMap aq, ak, av, ado, bq, bk, bv, bdo;
  MapDims maq, mak, mav, mado, mbq, mbk, mbv, mbdo;
  if (!map_bhsd(&aq, &maq, q, B, H, Sq, DQK, st, T::COLS, T::KQ, T::SWZ) ||
      !map_bhsd(&ak, &mak, k, B, KvH, Sk, DQK, st + 3, T::COLS, T::KK, T::SWZ) ||
      !map_bhsd(&av, &mav, v, B, KvH, Sk, DV, st + 6, T::COLS, T::KK, T::SWZ) ||
      !map_bhsd(&ado, &mado, dout, B, H, Sq, DV, st + 12, T::COLS, T::KQ, T::SWZ) ||
      !map_bhsd(&bq, &mbq, q, B, H, Sq, DQK, st, T::COLS, T::QQ, T::SWZ) ||
      !map_bhsd(&bk, &mbk, k, B, KvH, Sk, DQK, st + 3, T::COLS, T::QK, T::SWZ) ||
      !map_bhsd(&bv, &mbv, v, B, KvH, Sk, DV, st + 6, T::COLS, T::QK, T::SWZ) ||
      !map_bhsd(&bdo, &mbdo, dout, B, H, Sq, DV, st + 12, T::COLS, T::QQ, T::SWZ))
    return (int)cudaErrorInvalidValue;
  static bool attribute_set = false;             // once per instantiation
  if (!attribute_set) {
    int e = allow_smem(flash_bwd_dkdv_wgmma<DQK, DV, CAP>, T::DKDV_SMEM);
    if (!e) e = allow_smem(flash_bwd_dq_wgmma<DQK, DV, CAP>, T::DQ_SMEM);
    if (e) return e;
    attribute_set = true;
  }
  const Strides os{st[9], st[10], st[11]}, dos{st[12], st[13], st[14]};
  const Strides dqs{st[15], st[16], st[17]}, dks{st[18], st[19], st[20]};
  const Strides dvs{st[21], st[22], st[23]};
  const long long rows = (long long)B * H * Sq;
  const int per_block = THREADS / 32;
  flash_bwd_delta<__nv_bfloat16><<<(unsigned)((rows + per_block - 1) / per_block), THREADS, 0,
                                   stream>>>((const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
                                             delta, H, Sq, DV, os, dos, rows);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const int group = H / KvH;
  const float qk_mul = CAP ? scale / cap : scale * LOG2E, cap_log2 = cap * LOG2E;
  flash_bwd_dkdv_wgmma<DQK, DV, CAP><<<dim3(KvH, B, (Sk + T::KK - 1) / T::KK), T::THREADS,
                                       T::DKDV_SMEM, stream>>>(
      aq, ak, av, ado, maq, mak, mav, mado, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      dks, dvs, H, group, Sq, Sk, scale, qk_mul, causal, window, kv_len, cap_log2);
  e = (int)cudaGetLastError();
  if (e) return e;
  flash_bwd_dq_wgmma<DQK, DV, CAP><<<dim3(H, B, (Sq + T::QQ - 1) / T::QQ), T::THREADS,
                                     T::DQ_SMEM, stream>>>(
      bq, bk, bv, bdo, mbq, mbk, mbv, mbdo, lse, delta, (__nv_bfloat16*)dq, dqs, H, group, Sq,
      Sk, scale, qk_mul, causal, window, kv_len, cap_log2);
  return (int)cudaGetLastError();
}

template <bool CAP>
int launch_wgmma_dims(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int B, int H, int KvH, int Sq, int Sk, int D,
                      const long long* st, float scale, int causal, int window, int kv_len,
                      float cap, cudaStream_t s) {
  switch (D) {
    case 16: return launch_wgmma_d<16, 16, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 32: return launch_wgmma_d<32, 32, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 64: return launch_wgmma_d<64, 64, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 128: return launch_wgmma_d<128, 128, CAP>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: q, o, dout, dq (B,H,Sq,·); k, v, dk, dv (B,KvH,Sk,·), q, k, dq and
// dk of head dim D, v, o, dout and dv of Dv, each given by its pointer and its
// strides in elements over (batch, head, position) — twenty-four values in
// `strides`, in the order q, k, v, o, dout, dq, dk, dv — with the head dim
// contiguous; lse and delta (B,H,Sq) float32, contiguous (delta is scratch).
// All three take the same arguments.  The CUDA-core launchers take D = Dv
// (they refuse Dv != D) of 16, 32, 64, 128 or 256 (float32) or 256
// (bfloat16); the wgmma one (D, Dv) of (16, 16), (32, 32), (64, 64),
// (128, 128) or (192, 128), with q, k, v, o and dout 16-byte aligned and their strides whole 16 bytes (TMA's rule),
// dq, dk and dv 4-byte aligned with even strides.  `window` <= 0 means none;
// keys at positions >= `kv_len` are masked.  `cap` > 0 is the forward's logit
// cap, 0 none; (192, 128) takes none.  They launch the three kernels on
// `stream` and return cudaGetLastError() (cudaErrorInvalidValue for a shape
// they do not take).
extern "C" int launch_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H, int KvH, int Sq,
    int Sk, int D, int Dv, const long long* strides, float scale, int causal, int window,
    int kv_len, float cap, void* stream) {
  if (Dv != D) return (int)cudaErrorInvalidValue;
  return launch_any_cap<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, D,
                               strides, scale, causal, window, kv_len, cap,
                               (cudaStream_t)stream);
}

extern "C" int launch_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H, int KvH, int Sq,
    int Sk, int D, int Dv, const long long* strides, float scale, int causal, int window,
    int kv_len, float cap, void* stream) {
  if (Dv != D) return (int)cudaErrorInvalidValue;
  return launch_any_cap<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq,
                                       Sk, D, strides, scale, causal, window, kv_len, cap,
                                       (cudaStream_t)stream);
}

extern "C" int launch_flash_attention_bwd_bf16_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H, int KvH, int Sq,
    int Sk, int D, int Dv, const long long* strides, float scale, int causal, int window,
    int kv_len, float cap, void* stream) {
  if (bad_shape(B, H, KvH, Sq, Sk, kv_len) || cap < 0.f ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout) % 16 ||
      ((uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 4)
    return (int)cudaErrorInvalidValue;
  // q, k, v, o and dout in whole 16 bytes, dq, dk and dv in bf16 pairs
  for (int i = 0; i < 24; ++i)
    if (strides[i] % (i < 15 ? 8 : 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the pairs with D != Dv are BF16_PAIRS of kernels/flash_attention.py
  if (D == 192 && Dv == 128 && cap == 0.f)
    return launch_wgmma_d<192, 128, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, cap, s);
  if (Dv != D) return (int)cudaErrorInvalidValue;
  if (cap > 0.f)
    return launch_wgmma_dims<true>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, D, strides, scale, causal, window, kv_len, cap, s);
  return launch_wgmma_dims<false>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, D, strides, scale, causal, window, kv_len, cap, s);
}
