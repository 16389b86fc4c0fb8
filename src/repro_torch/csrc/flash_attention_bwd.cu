// The gradient of flash attention (causal / sliding-window / kv_len masks, GQA):
// dQ, dK and dV from Q, K, V, the forward's output O, its row log-sum-exps
// and dO, in three launches.  One template over the storage type (float32 or
// bfloat16) with float32 arithmetic throughout.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of the
// plain jnp attention (repro/models/attention.py:63, `flash_attention`, under
// `jax.value_and_grad` in repro/train/steps.py).  On the card the forward is
// K3 (csrc/flash_attention.cu), which writes lse = m + log l of each row when
// asked; this is its backward.  With P = exp(s - lse), s = scale q.k, masked
// pairs P = 0:
//   flash_bwd_delta  Delta = rowsum(dO o O), one warp a row;
//   flash_bwd_dkdv   one block per (key tile, KV head, lane): K and V tiles
//                    stay in shared memory; for each query head of the group
//                    and each query tile the masks leave, S and dP = dO V^T
//                    are recomputed, dS = P o (dP - Delta), and
//                    dV += P^T dO, dK += scale dS^T Q accumulate in registers;
//   flash_bwd_dq     one block per (query tile, head, lane): Q and dO stay in
//                    shared memory; over the key tiles the masks leave, S, dP
//                    and dS again, and dQ += scale dS K in registers.
// Each output element is written by one thread of one block, once: no atomics,
// so a call is deterministic.  A GQA group's dK and dV are summed over its
// query heads inside the block.
//
// Bound on this card: operations.  The function needs five products of
// 2 B H Sq Sk D operations over the pairs the masks leave (S, dP, dV, dK, dQ:
// 10 B H Sq Sk D / 2 causal); at tinyllama's training shape (B 4, S 2048,
// H 32, D 64) that is 172 GFLOP, 0.174 ms at 989 TFLOP/s bf16, against about
// 150 MB of inputs and outputs, 0.045 ms at 3.35 TB/s.  This first kernel runs
// on the CUDA cores (S and dP are recomputed in both passes: seven products),
// so it sits far above that bound; the tensor cores (mma.sync or wgmma) are the
// redesign's.  Its loads: the S and dP products read rows of Q, dO, K and V
// along D as float4 from tiles padded by 4 floats (free of bank conflicts), and
// the output products read one row of dS or P per step, broadcast.
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;       // a 16 x 16 grid of threads over each tile

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int group, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides dos,
               Strides dks, Strides dvs, float scale, int causal, int window, int kv_len) {
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
          const float p = visible(q0 + r, k0 + c, Sq, kv_len, causal, window)
                              ? expf(s[x][y] * scale - lt[r]) : 0.f;
          pt[r * PP + c] = p;
          st[r * PP + c] = p * (dp[x][y] - et[r]);
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int group, int Sq, int Sk,
             Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
             int causal, int window, int kv_len) {
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
        const float p = visible(q0 + r, k0 + c, Sq, kv_len, causal, window)
                            ? expf(s[x][y] * scale - lt[r]) : 0.f;
        st[r * PP + c] = p * (dp[x][y] - et[r]);
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

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse,
             float* delta, T* dq, T* dk, T* dv, int B, int H, int KvH, int Sq, int Sk,
             const long long* st, float scale, int causal, int window, int kv_len,
             cudaStream_t stream) {
  using P = Bwd<D>;
  static bool attribute_set = false;           // once per instantiation
  if (!attribute_set) {
    int e = allow_smem(flash_bwd_dkdv<T, D>, P::SMEM);
    if (!e) e = allow_smem(flash_bwd_dq<T, D>, P::SMEM);
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
  flash_bwd_dkdv<T, D><<<dim3((Sk + P::BK - 1) / P::BK, KvH, B), THREADS, P::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, H / KvH, Sq, Sk, qs, ks, vs, dos, dks, dvs, scale,
      causal, window, kv_len);
  e = (int)cudaGetLastError();
  if (e) return e;
  flash_bwd_dq<T, D><<<dim3((Sq + P::BQ - 1) / P::BQ, H, B), THREADS, P::SMEM, stream>>>(
      q, k, v, dout, lse, delta, dq, H / KvH, Sq, Sk, qs, ks, vs, dos, dqs, scale, causal,
      window, kv_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int H,
               int KvH, int Sq, int Sk, int D, const long long* st, float scale, int causal,
               int window, int kv_len, cudaStream_t s) {
  if (B <= 0 || H <= 0 || KvH <= 0 || H % KvH || Sq <= 0 || Sk <= 0 || kv_len <= 0 ||
      kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  // the float4 reads of the tiles come from shared memory, so the operands'
  // rows need no alignment here
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v, *to = (const T*)o;
  const T* tg = (const T*)dout;
  T *gq = (T*)dq, *gk = (T*)dk, *gv = (T*)dv;
  switch (D) {
    case 16: return launch_d<T, 16>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, s);
    case 32: return launch_d<T, 32>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, s);
    case 64: return launch_d<T, 64>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, s);
    case 128: return launch_d<T, 128>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, s);
    case 256: return launch_d<T, 256>(tq, tk, tv, to, tg, lse, delta, gq, gk, gv, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: q, o, dout, dq (B,H,Sq,D); k, v, dk, dv (B,KvH,Sk,D), each given by
// its pointer and its strides in elements over (batch, head, position) —
// twenty-four values in `strides`, in the order q, k, v, o, dout, dq, dk, dv —
// with the head dim contiguous; lse and delta (B,H,Sq) float32, contiguous
// (delta is scratch).  D is 16, 32, 64, 128 or 256.  `window` <= 0 means none;
// keys at positions >= `kv_len` are masked.  They launch the three kernels on
// `stream` and return cudaGetLastError() (cudaErrorInvalidValue for a shape
// they do not take).
extern "C" int launch_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const float* lse,
                                              float* delta, void* dq, void* dk, void* dv, int B,
                                              int H, int KvH, int Sq, int Sk, int D,
                                              const long long* strides, float scale, int causal,
                                              int window, int kv_len, void* stream) {
  return launch_any<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk, D,
                           strides, scale, causal, window, kv_len, (cudaStream_t)stream);
}

extern "C" int launch_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const float* lse,
                                               float* delta, void* dq, void* dk, void* dv, int B,
                                               int H, int KvH, int Sq, int Sk, int D,
                                               const long long* strides, float scale, int causal,
                                               int window, int kv_len, void* stream) {
  return launch_any<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, KvH, Sq, Sk,
                                   D, strides, scale, causal, window, kv_len,
                                   (cudaStream_t)stream);
}
