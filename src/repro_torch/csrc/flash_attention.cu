// Flash attention (causal / sliding-window / kv_len masks, GQA), one pass over
// the keys with an online softmax: one kernel per dtype.
//
// Replaces: repro/kernels/flash_attention.py:96, the `pallas_call` of
// `_flash_kernel` (grid (B, H, Sq/bq, Sk/bk), KV innermost and sequential on the
// TPU, with (acc, m, l) carried in VMEM scratch across the KV steps).  On the
// card the sequential KV dimension is a loop inside one block per (q-block,
// head, lane) over tiles of keys; under a causal mask it stops at the block's
// diagonal, under a window it starts at the first tile any row can see, and
// the longest q-blocks launch first.  The KV head is h / (H / KvH), never
// replicated.  Keys at or past Sk do not exist (-inf, weight 0) and query rows
// at or past Sq are not stored, so the caller never pads.  Semantics are the
// Pallas body's: a masked score is -1e30 (not -inf: a row that has seen only
// masked keys holds m = -1e30 and p = exp(0) until a valid key rescales its
// sums by exp(-1e30 - m) = 0), and the output is acc / max(l, 1e-30).
//
// Bound on this card: operations.  Under a causal mask the two products take
// 2*B*H*Sq*Sk*D floating-point operations (half of 4*B*H*Sq*Sk*D); at the shape
// of a 1024-token prefill of tinyllama (B 4, H 32, D 64) that is 17.2 GFLOP, or
// 0.017 ms at 989 TFLOP/s bf16, against 38 MB of Q, K, V and O, or 0.011 ms at
// 3.35 TB/s.
//
// bfloat16 (`flash_bf16_wgmma`), head dims 16-256.  Both products run on the
// tensor cores, `wgmma.mma_async` m64nNk16 with f32 accumulators.  A block is
// one or two consumer warpgroups of 64 query rows each and one producer
// warpgroup, of which one thread works.  It loads Q once and K, V tiles into a
// ring of stages with TMA (`cp.async.bulk.tensor.4d` over (D, head, position,
// batch) with the caller's strides, so the (B,H,S,D) views of the model's
// (B,S,H,D) tensors are read without a copy; keys past Sk arrive as zeros and
// are scored -inf); stages complete on mbarriers and go back to the producer
// when every consumer warp is done with them.  S = Q K^T takes Q and K
// K-major from shared memory (swizzled as wide as a row of D allows, 128 bytes
// at D >= 64).  The scale is folded with log2(e) into the f32 scores and the
// softmax runs on exp2; masks are selects against each row's bounds, applied
// only in tiles that a mask reaches (a test per element, in every tile, took
// a third of the time).  Row maxima and sums reduce over the 4 threads that
// share a row.  P is rounded to bf16 in registers, where the f32 fragment of
// S is already the A fragment of O += P V, so P never goes through shared
// memory; V enters as an N-major B through wgmma's transpose bit.  D <= 128:
// two consumer warpgroups (128 rows), tiles of 128 keys, a ring of 3 stages;
// `setmaxnreg` moves registers from the producer to them.  D 256: the O
// accumulator alone is 128 f32 registers a thread, and ptxas allots a
// 384-thread block 168 a thread whatever `setmaxnreg` asks later (it spilled
// 316 bytes), so the block is one consumer warpgroup (64 rows) and the
// producer, 256 threads with up to 255 registers each, no spill; tiles of 64
// keys, a ring of 2: Q and the ring take 160 KB of the 227 KB a block may use.
// Multi-head latent attention scores over 192 dims (128 decompressed and 64
// rotary) and averages values of 128: the template takes the two head dims
// apart, `flash_bf16_wgmma<DQK, DV>`, and <192, 128> is the one pair with
// DQK != DV.  S = Q K^T runs 12 k16 steps through three 128-byte boxes of Q
// and K, O += P V is N = 128 wide as at D 128, and a K tile of 128 keys is
// 48 KB beside V's 32: a ring of 2 stages, 209 KB with Q.  Two consumer
// warpgroups, as at D 128 (the registers are those of D 128: O and S take
// 64 each).  The one rounding beyond the Pallas body's is P to bf16 before P V.
//
// float32 (`flash_f32`), head dims 16-256: the CUDA cores, 2e-5 of the plain
// version (TF32 could not meet it).  One block of four warps per (q-block of
// 64 rows, head, batch) over tiles of 64 keys.  Each tile of K (and V) is
// staged once in shared memory and serves all 64 query rows.  Each warp owns
// 16 query rows: a lane computes the scores of 2 keys for all 16 rows (float4
// reads; the rows of Q and K are padded by 4 floats so those reads are free of
// bank conflicts), the row maxima are all-reduced over the warp, the
// probabilities go through shared memory, and the lane accumulates D/2 outputs
// of P.V; (acc, m) live in registers and l as per-lane partial sums.  Scores
// are (q * scale) . k.  At D 256 its accumulator spills.
//
// Logit soft-capping: under a cap c each scaled score s becomes c tanh(s / c)
// before the masks, and the softmax and lse are over the capped scores, as in
// the reference's plain attention (repro/models/attention.py:97).  Both
// kernels take it as a template parameter CAP beside a runtime `cap`, so the
// uncapped instantiations are the code they were.  float32 takes tanhf; bf16
// takes `tanh.approx.f32` on the raw product times scale/c, and multiplies
// the result by c log2(e) where the uncapped kernel multiplies by scale
// log2(e).  A capped score costs a MUFU tanh beside its exp2: at 16 a cycle
// an SM, the two special functions of a pair can outlast the two products
// (4 D flops a pair on the tensor cores) below D 128.  No capped <192, 128>
// is built: the reference's MLA ignores the cap.
//
// Training: where the caller passes an `lse` buffer, both kernels also write
// each query row's log-sum-exp, m + log l in natural units (the bf16 kernel's m
// is in log2 units: m ln 2 + log l), which the backward
// (flash_attention_bwd.cu) takes to rebuild P = exp(s - lse).  Serving passes
// null and pays one test a block.
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;             // query rows per block (f32)
constexpr int BK = 64;             // keys per tile (f32)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;   // query rows per warp
constexpr int PS = BK + 4;         // row stride of the probability tile (floats)
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
#define ABSENT __int_as_float(0xff800000u)  // -inf: a key past the end, weight 0

struct Strides {
  long long b, h, s;               // in elements; the head dim is contiguous
};

// -- float32 on the CUDA cores ----------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 4) + (size_t)BK * (D + 4) + (size_t)BK * D + (size_t)BQ * PS;
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
flash_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, float* __restrict__ lse, int group, int Sq, int Sk, Strides qs,
          Strides ks, Strides vs, Strides os, float scale, int causal, int window, int kv_len,
          float cap) {
  constexpr int DP = D + 4;                // padded row stride of the Q and K tiles
  constexpr int DL = D < 32 ? D : 32;      // lanes along the head dim in P.V
  constexpr int RG = 32 / DL;              // lane groups along the rows in P.V
  constexpr int RPL = ROWS / RG;           // rows of P.V per lane
  constexpr int DPL = D / DL;              // dims of P.V per lane
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // (BQ, DP) q * scale
  float* kt = qt + BQ * DP;                      // (BK, DP)
  float* vt = kt + BK * DP;                      // (BK, D)
  float* pt = vt + BK * D;                       // (BQ, PS) probabilities

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dl = lane % DL, rg = lane / DL;
  // last q-blocks first: under a causal mask they have the most tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + kvh * ks.h;
  const float* vp = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < BQ * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = load4(qp + (q0 + r) * qs.s + c);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(qt + r * DP + c) = x;
  }

  float m[ROWS], l[ROWS], acc[RPL][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) { m[r] = MASKED; l[r] = 0.f; }
#pragma unroll
  for (int u = 0; u < RPL; ++u)
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[u][t] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  // tiles wholly before every row's window are masked for all rows; skipping
  // them is exact (each row meets a valid key later, which zeroes them)
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const float* qrow = qt + warp * ROWS * DP;
  float* prow = pt + warp * ROWS * PS;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();                       // the previous tile is consumed
    for (int e = tid; e < BK * D / 4; e += THREADS) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (k0 + r < Sk) {
        x = load4(kp + (k0 + r) * ks.s + c);
        y = load4(vp + (k0 + r) * vs.s + c);
      }
      *reinterpret_cast<float4*>(kt + r * DP + c) = x;
      *reinterpret_cast<float4*>(vt + r * D + c) = y;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 against the warp's rows
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(kt + lane * DP + c);
      const float4 kb = *reinterpret_cast<const float4*>(kt + (lane + 32) * DP + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * DP + c);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kb, s[r][1]);
      }
    }

    float corr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool ok = kpos < kv_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if constexpr (CAP) s[r][j] = tanhf(s[r][j] / cap) * cap;
        s[r][j] = kpos >= Sk ? ABSENT : (ok ? s[r][j] : MASKED);
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      corr[r] = expf(m[r] - m_new);
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      l[r] = l[r] * corr[r] + (p0 + p1);
      m[r] = m_new;
      prow[r * PS + lane] = p0;
      prow[r * PS + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll
    for (int u = 0; u < RPL; ++u) {
      float c = corr[u * RG];
#pragma unroll
      for (int g = 1; g < RG; ++g)
        if (rg == g) c = corr[u * RG + g];
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[u][t] *= c;
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int t = 0; t < DPL; ++t) vv[jj][t] = vt[(j + jj) * D + dl + DL * t];
#pragma unroll
      for (int u = 0; u < RPL; ++u) {
        const float4 p = *reinterpret_cast<const float4*>(prow + (u * RG + rg) * PS + j);
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          acc[u][t] = fmaf(p.w, vv[3][t], fmaf(p.z, vv[2][t],
                      fmaf(p.y, vv[1][t], fmaf(p.x, vv[0][t], acc[u][t]))));
      }
    }
    __syncwarp();                          // P is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) l[r] = warp_sum(l[r]);
  if (lse != nullptr && lane == 0) {         // the backward's row statistics
    float* lrow = lse + ((long long)b * gridDim.y + h) * Sq;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (q0 + warp * ROWS + r < Sq) lrow[q0 + warp * ROWS + r] = m[r] + logf(l[r]);
  }
  float* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int u = 0; u < RPL; ++u) {
    float den = l[u * RG];
#pragma unroll
    for (int g = 1; g < RG; ++g)
      if (rg == g) den = l[u * RG + g];
    den = fmaxf(den, 1e-30f);
    const int qpos = q0 + warp * ROWS + u * RG + rg;
    if (qpos < Sq) {
#pragma unroll
      for (int t = 0; t < DPL; ++t) op[qpos * os.s + dl + DL * t] = acc[u][t] / den;
    }
  }
}

template <int D, bool CAP>
int launch_f32_d(const float* q, const float* k, const float* v, float* o, float* lse, int B, int H,
                 int KvH, int Sq, int Sk, const long long* st, float scale, int causal,
                 int window, int kv_len, float cap, cudaStream_t stream) {
  auto kernel = flash_f32<D, CAP>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;       // above 48 KB a kernel must ask, once
  if (smem > 48 * 1024 && !attribute_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, H / KvH, Sq, Sk, qs, ks, vs, os,
                                          scale, causal, window, kv_len, cap);
  return (int)cudaGetLastError();
}

template <bool CAP>
int launch_f32_any(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                   int H, int KvH, int Sq, int Sk, int D, const long long* st, float scale,
                   int causal, int window, int kv_len, float cap, cudaStream_t s) {
  switch (D) {
    case 16: return launch_f32_d<16, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 32: return launch_f32_d<32, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 64: return launch_f32_d<64, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 128: return launch_f32_d<128, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 256: return launch_f32_d<256, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}

// -- bfloat16 on the tensor cores ---------------------------------------------------

// DQK is the head dim of Q and K (the depth of S = Q K^T), DV that of V and O
// (the width of O += P V); they differ only for multi-head latent attention,
// whose queries and keys carry a rotary part beside the value's dims.
template <int DQK, int DV>
struct WgTile {
  static_assert(DQK == DV || (DQK % 64 == 0 && DV % 64 == 0),
                "head dims that differ must both be whole 128-byte boxes");
  // warpgroups of 64 query rows: at DV 256 one, whose 128 accumulators of O
  // and the scores then have the registers of a 256-thread block
  static constexpr int CONSUMERS = DV == 256 ? 1 : 2;
  static constexpr int BQ = 64 * CONSUMERS;           // query rows per block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);   // and one producer warpgroup
  static constexpr int BK = DQK == 256 ? 64 : 128;    // keys per tile
  // (K, V) tiles in the ring: two where a K tile is wider than 128 dims
  static constexpr int STAGES = DQK > 128 ? 2 : 3;
  static constexpr int SWZ = DQK >= 64 ? 128 : DQK * 2;   // bytes of a box row, its swizzle
  static constexpr int COLS = SWZ / 2;                // head dims a box
  static constexpr int QK_BOXES = DQK / COLS;         // boxes of a row of Q or K
  static constexpr int V_BOXES = DV / COLS;           // of a row of V
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BK * DQK * 2;        // K of one tile
  static constexpr int V_BYTES = BK * DV * 2;         // V of one tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // slack to align to 1 KB (where a swizzle atom starts), Q, the ring, barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 64;
  static_assert(SMEM <= SMEM_LIMIT, "the tiles do not fit a block's shared memory");
};

// qk_mul multiplies the raw products: scale log2(e), or under a cap scale / c,
// whose tanh then takes cap_log2 = c log2(e)
template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(WgTile<DQK, DV>::THREADS, 1)
flash_bf16_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, MapDims mq, MapDims mk, MapDims mv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, Strides os, int group,
                 int Sq, int Sk, float qk_mul, int causal, int window, int kv_len,
                 float cap_log2) {
  using T = WgTile<DQK, DV>;
  constexpr int TK = T::BK, SWZ = T::SWZ, COLS = T::COLS, BQ = T::BQ, STAGES = T::STAGES;
  extern __shared__ __align__(1024) uint8_t fsm[];
  const uint32_t base = (smem_u32(fsm) + 1023u) & ~1023u;
  const uint32_t q_sm = base, ring = base + T::Q_BYTES;
  const uint32_t q_full = ring + STAGES * T::STAGE_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;

  const int wg = threadIdx.x / 128;
  // last q-blocks first: under a causal mask they have the most tiles
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  // keys at or past kv_len are masked for every row, so tiles wholly past it
  // are skipped, as are tiles wholly before every row's window (each row meets
  // a valid key, which zeroes what they would add)
  const int kv_end = min(causal ? min(Sk, q0 + BQ) : Sk, kv_len);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / TK * TK : 0;
  const int tiles = kv_end > kv_begin ? (kv_end - kv_begin + TK - 1) / TK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * T::CONSUMERS);   // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::CONSUMERS) {
    // producer: one thread loads Q, then keeps the ring full
    if constexpr (T::CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int j = 0; j < T::QK_BOXES; ++j)
        tma_load_bhsd(q_sm + j * BQ * SWZ, &tq, mq, j * COLS, h, q0, b, q_full);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + 8 * s, ((t / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t k_sm = ring + s * T::STAGE_BYTES, v_sm = k_sm + T::K_BYTES;
        mbar_expect_tx(bar, T::STAGE_BYTES);
        const int k0 = kv_begin + t * TK;
        for (int j = 0; j < T::QK_BOXES; ++j)
          tma_load_bhsd(k_sm + j * TK * SWZ, &tk, mk, j * COLS, kvh, k0, b, bar);
        for (int j = 0; j < T::V_BOXES; ++j)
          tma_load_bhsd(v_sm + j * TK * SWZ, &tv, mv, j * COLS, kvh, k0, b, bar);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + wg*64 .. +63.  Accumulator i of a
    // thread is row w*16 + l/4 + 8*((i/2)%2), column 8*(i/4) + 2*(l%4) + i%2.
    if constexpr (T::CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t128 = threadIdx.x % 128, w = t128 / 32, l = t128 % 32;
    const int wq0 = q0 + wg * 64;                    // first row of the warpgroup
    const int row0 = wq0 + w * 16 + l / 4;           // this thread's rows: row0, row0 + 8
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {MASKED, MASKED}, lsum[2] = {0.f, 0.f};
    const uint32_t q_wg = q_sm + wg * 64 * SWZ;
    mbar_wait(q_full, 0);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = kv_begin + t * TK;
      const uint32_t k_sm = ring + s * T::STAGE_BYTES, v_sm = k_sm + T::K_BYTES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);

      // S = Q K^T: k16 step kk lies in box kk*16/COLS, 32 bytes a step into its rows
      float sc[TK / 2];
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t in_box = (kk * 16 / COLS), off = (kk * 16 % COLS) * 2;
        const uint64_t da = smem_desc(q_wg + in_box * BQ * SWZ + off, 16, 8 * SWZ, SWZ);
        const uint64_t db = smem_desc(k_sm + in_box * TK * SWZ + off, 16, 8 * SWZ, SWZ);
        wgmma_ss<TK>(sc, da, db, 0);
      }
      wgmma_commit();
      wgmma_wait_all();

      // scale (and cap); masks only where one reaches this tile, as selects
      // against each row's bounds, relative to this thread's first column
      // k0 + 2*(l%4)
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        if constexpr (CAP) sc[i] = tanh_approx(sc[i] * qk_mul) * cap_log2;
        else sc[i] *= qk_mul;
      }
      if (k0 + TK > kv_len || (causal && k0 + TK - 1 > wq0) ||
          (window > 0 && k0 <= wq0 + 63 - window)) {
        const int base_col = k0 + 2 * (l % 4);
        const int absent = Sk - base_col;
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qpos = row0 + 8 * r;
          hi[r] = (causal ? min(kv_len - 1, qpos) : kv_len - 1) - base_col;
          lo[r] = window > 0 ? qpos - window + 1 - base_col : -TK;
        }
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) {
          const int c = 8 * (i >> 2) + (i & 1), r = (i >> 1) & 1;
          sc[i] = c >= absent ? ABSENT : (c >= lo[r] && c <= hi[r] ? sc[i] : MASKED);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        lsum[r] *= corr[r];
      }
      // P: the f32 fragment of S, rounded to bf16 pairs, is the A fragment of
      // k16 step kk: a0..a3 = accumulators 8kk + {0,1}, {2,3}, {4,5}, {6,7}
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = kk * 8 + j * 2, r = j & 1;
          const float p0 = exp2f(sc[i] - m[r]), p1 = exp2f(sc[i + 1] - m[r]);
          lsum[r] += p0 + p1;
          __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
          pa[kk][j] = *reinterpret_cast<uint32_t*>(&pair);
        }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P V: V is (keys, DV), N-major; k16 step kk is 16 rows down, the
      // boxes of COLS columns lie TK*SWZ bytes apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<DV>(acc, pa[kk], smem_desc(v_sm + kk * 16 * SWZ, TK * SWZ, 8 * SWZ, SWZ));
      wgmma_commit();
      wgmma_wait_all();
      if (l == 0) mbar_arrive(empty + 8 * s);
    }

    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
      const float den = fmaxf(lsum[r], 1e-30f);
      const int row = row0 + 8 * r;
      // the backward's row statistics, in natural units: m is in log2 units
      if (lse != nullptr && (l & 3) == 0 && row < Sq)
        lse[((long long)b * gridDim.y + h) * Sq + row] = m[r] * LN2 + logf(lsum[r]);
      if (row < Sq) {
        __nv_bfloat16* orow = ob + (long long)row * os.s + 2 * (l % 4);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

template <int DQK, int DV, bool CAP>
int launch_bf16_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                  int KvH, int Sq, int Sk, const long long* st, float scale, int causal,
                  int window, int kv_len, float cap, cudaStream_t stream) {
  using T = WgTile<DQK, DV>;
  CUtensorMap tq, tk, tv;
  MapDims mq, mk, mv;
  if (!map_bhsd(&tq, &mq, q, B, H, Sq, DQK, st, T::COLS, T::BQ, T::SWZ) ||
      !map_bhsd(&tk, &mk, k, B, KvH, Sk, DQK, st + 3, T::COLS, T::BK, T::SWZ) ||
      !map_bhsd(&tv, &mv, v, B, KvH, Sk, DV, st + 6, T::COLS, T::BK, T::SWZ))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_bf16_wgmma<DQK, DV, CAP>;
  static bool attribute_set = false;       // once per instantiation
  if (!attribute_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM);
    if (e != cudaSuccess) return (int)e;
    attribute_set = true;
  }
  const Strides os{st[9], st[10], st[11]};
  dim3 grid((Sq + T::BQ - 1) / T::BQ, H, B);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, mq, mk, mv, (__nv_bfloat16*)o, lse,
                                                os, H / KvH, Sq, Sk,
                                                CAP ? scale / cap : scale * LOG2E, causal,
                                                window, kv_len, cap * LOG2E);
  return (int)cudaGetLastError();
}

template <bool CAP>
int launch_bf16_any(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                    int H, int KvH, int Sq, int Sk, int D, const long long* st, float scale,
                    int causal, int window, int kv_len, float cap, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bf16_d<16, 16, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 32: return launch_bf16_d<32, 32, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 64: return launch_bf16_d<64, 64, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 128: return launch_bf16_d<128, 128, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
    case 256: return launch_bf16_d<256, 256, CAP>(q, k, v, o, lse, B, H, KvH, Sq, Sk, st, scale, causal, window, kv_len, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int KvH, int Sq, int Sk, int kv_len) {
  return B <= 0 || H <= 0 || KvH <= 0 || H % KvH || Sq <= 0 || Sk <= 0 || kv_len <= 0 ||
         kv_len > Sk;
}

}  // namespace

// Launchers: q and k (B,H,Sq,D) and (B,KvH,Sk,D), v (B,KvH,Sk,Dv), o (B,H,Sq,Dv),
// Dv = D but for the bfloat16 pair (D 192, Dv 128), each given by its
// pointer and its strides in elements over (batch, head, position) — twelve
// values in `strides`, in the order q, k, v, o — with the head dim contiguous.
// float32: rows 16-byte aligned; bfloat16: q, k, v 16-byte aligned with
// strides of whole 16 bytes (TMA's rule), o's rows 4-byte aligned.  `window`
// <= 0 means none; keys at positions >= `kv_len` are masked.  `lse`, where not
// null, takes each query row's log-sum-exp of its scaled scores, m + log l in
// natural units, (B,H,Sq) float32 contiguous: the statistics the backward
// (flash_attention_bwd.cu) needs.  D is 16, 32, 64, 128 or 256 (or 192 with Dv
// 128, uncapped).  `cap` > 0 caps the scaled scores (c tanh(s / c)); 0 means
// none.  They launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for a shape they do not take).
extern "C" int launch_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int B, int H, int KvH, int Sq, int Sk, int D,
                                          int Dv, const long long* strides, float scale,
                                          int causal, int window, int kv_len, float cap,
                                          void* stream) {
  // built for D == Dv only: the caller pads a pair with D != Dv to one head dim
  if (bad_shape(B, H, KvH, Sq, Sk, kv_len) || Dv != D || cap < 0.f)
    return (int)cudaErrorInvalidValue;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v;
  float* fo = (float*)o;
  cudaStream_t s = (cudaStream_t)stream;
  if (cap > 0.f)
    return launch_f32_any<true>(fq, fk, fv, fo, lse, B, H, KvH, Sq, Sk, D, strides, scale, causal, window, kv_len, cap, s);
  return launch_f32_any<false>(fq, fk, fv, fo, lse, B, H, KvH, Sq, Sk, D, strides, scale, causal, window, kv_len, cap, s);
}

extern "C" int launch_flash_attention_bf16_wgmma(const void* q, const void* k, const void* v,
                                                 void* o, float* lse, int B, int H, int KvH, int Sq, int Sk,
                                                 int D, int Dv, const long long* strides,
                                                 float scale, int causal, int window,
                                                 int kv_len, float cap, void* stream) {
  if (bad_shape(B, H, KvH, Sq, Sk, kv_len) || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 ||
      cap < 0.f)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the pairs with D != Dv are BF16_PAIRS of kernels/flash_attention.py (a
  // test holds the two lists equal), built without a cap
  if (D == 192 && Dv == 128 && cap == 0.f)
    return launch_bf16_d<192, 128, false>(q, k, v, o, lse, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, cap, s);
  if (Dv != D) return (int)cudaErrorInvalidValue;
  if (cap > 0.f)
    return launch_bf16_any<true>(q, k, v, o, lse, B, H, KvH, Sq, Sk, D, strides, scale, causal, window, kv_len, cap, s);
  return launch_bf16_any<false>(q, k, v, o, lse, B, H, KvH, Sq, Sk, D, strides, scale, causal, window, kv_len, cap, s);
}
