// Flash attention (causal / sliding-window / kv_len masks, GQA) for float and
// bfloat16 inputs, one pass over the keys with an online softmax.
//
// Replaces: repro/kernels/flash_attention.py:96, the `pallas_call` of
// `_flash_kernel` (grid (B, H, Sq/bq, Sk/bk), KV innermost and sequential on the
// TPU, with (acc, m, l) carried in VMEM scratch across the KV steps).
//
// Bound on this card: operations. Under a causal mask the two products take
// 2*B*H*Sq*Sk*D floating-point operations (half of 4*B*H*Sq*Sk*D); at the shape
// of a 1024-token prefill of tinyllama (B 4, H 32, D 64) that is 17.2 GFLOP, or
// 0.017 ms at 989 TFLOP/s bf16, against 38 MB of Q, K, V and O, or 0.011 ms at
// 3.35 TB/s.
//
// Design: one block of four warps per (q-block of 64 rows, head, batch). The
// TPU's sequential KV grid dimension is a loop inside the block over tiles of
// 64 keys; under a causal mask it stops at the block's diagonal and under a
// window it starts at the first tile any row can see, so the work is the
// causal half. Each tile of K (and V) is staged once in shared memory as float
// and serves all 64 query rows; the KV head is h / (H / KvH), never replicated.
// Each warp owns 16 query rows: a lane computes the scores of 2 keys for all 16
// rows (float4 reads; the rows of Q and K are padded by 4 floats so those reads
// are free of bank conflicts), the row maxima are all-reduced over the warp,
// the probabilities go through shared memory, and the lane accumulates D/2
// outputs of P.V. (acc, m) live in registers and l as per-lane partial sums,
// added up once at the end. Arithmetic is float32 on the CUDA cores, as in the
// Pallas body: scores are (q * scale) . k, masked scores are -1e30 (not -inf:
// a row that has seen only masked keys holds m = -1e30 and p = exp(0) until a
// valid key rescales its sums by exp(-1e30 - m) = 0), and the output is
// acc / max(l, 1e-30), rounded to nearest even. Keys at or past Sk do not
// exist (-inf, weight 0) and query rows at or past Sq are not stored, so the
// caller never pads. The tensor cores (wgmma) and TMA are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;   // query rows per warp
constexpr int PS = BK + 4;         // row stride of the probability tile (floats)
constexpr float MASKED = -1e30f;
#define ABSENT __int_as_float(0xff800000u)  // -inf: a key past the end, weight 0

struct Strides {
  long long b, h, s;               // in elements; the head dim is contiguous
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // four bfloat16 values: each is the high half of its float
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int group, int Sq, int Sk, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal, int window, int kv_len) {
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
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;

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
  T* op = o + b * os.b + h * os.h;
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
      for (int t = 0; t < DPL; ++t) store(op + qpos * os.s + dl + DL * t, acc[u][t] / den);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int KvH,
             int Sq, int Sk, const long long* st, float scale, int causal, int window,
             int kv_len, cudaStream_t stream) {
  auto kernel = flash_kernel<T, D>;
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
  kernel<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                          H / KvH, Sq, Sk, qs, ks, vs, os, scale, causal,
                                          window, kv_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KvH,
           int Sq, int Sk, int D, const long long* strides, float scale, int causal,
           int window, int kv_len, void* stream) {
  if (B <= 0 || H <= 0 || KvH <= 0 || H % KvH || Sq <= 0 || Sk <= 0 || kv_len <= 0 ||
      kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, s);
    case 32: return launch_d<T, 32>(q, k, v, o, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, s);
    case 64: return launch_d<T, 64>(q, k, v, o, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, s);
    case 128: return launch_d<T, 128>(q, k, v, o, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, s);
    case 256: return launch_d<T, 256>(q, k, v, o, B, H, KvH, Sq, Sk, strides, scale, causal, window, kv_len, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: q (B,H,Sq,D), k and v (B,KvH,Sk,D), o (B,H,Sq,D), each given by its
// pointer and its strides in elements over (batch, head, position) — twelve
// values in `strides`, in the order q, k, v, o — with the head dim contiguous,
// rows 16-byte aligned. `window` <= 0 means none; keys at positions >= `kv_len`
// are masked. They launch on `stream` and return cudaGetLastError().
extern "C" int launch_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int KvH, int Sq, int Sk, int D,
                                          const long long* strides, float scale, int causal,
                                          int window, int kv_len, void* stream) {
  return launch<float>(q, k, v, o, B, H, KvH, Sq, Sk, D, strides, scale, causal, window,
                       kv_len, stream);
}

extern "C" int launch_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int KvH, int Sq, int Sk, int D,
                                           const long long* strides, float scale, int causal,
                                           int window, int kv_len, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, KvH, Sq, Sk, D, strides, scale, causal,
                               window, kv_len, stream);
}
