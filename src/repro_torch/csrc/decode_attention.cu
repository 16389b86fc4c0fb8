// Decode attention: one query token per (batch lane, head) against a KV cache,
// for float and bfloat16 inputs, with a length per lane or one for all.
//
// Replaces: repro/kernels/decode_attention.py:73, the `pallas_call` of
// `_decode_kernel` (grid (B, H, L/bk), the cache length innermost and
// sequential on the TPU, (acc, m, l) carried in VMEM scratch; `normalize=False`
// returns the unnormalised acc with (m, l) for `merge_partials`).
//
// Bound on this card: bytes. Every cache row a lane attends to is read once,
// 2*KvH*D elements, for 4*H*D floating-point operations: about two operations
// per byte in bfloat16, far below the ~295 at which the tensor cores would
// become the limit. At 4 lanes of a 1024-position cache of tinyllama (KvH 4,
// D 64) that is 4.2 MB, or 1.3 us at 3.35 TB/s.
//
// Design: the cache length is split into chunks of 64 positions. Pass 1 runs
// one block per (chunk, KV head, lane): it stages the chunk's K and V rows in
// shared memory once, as float, and serves all G = H/KvH query heads of that
// KV head from them, so each cache row is read once and never replicated; it
// writes an unnormalised partial (acc, m, l) per head. Chunks wholly past a
// lane's length are not read (their weight exp(-1e30 - m) would be 0). At 4
// lanes, 4 KV heads and 16 chunks that is 256 blocks for the 132 SMs, where one
// block per (lane, head) would give 16. Pass 2, one block per (lane, head),
// merges the chunks by log-sum-exp, as `merge_partials` does, and normalises
// (acc / max(l, 1e-30)) or returns (acc, m, l). Both passes are one launch of
// this library. Arithmetic is float32: scores are (q * scale) . k, positions at
// or past the length score -1e30, as in the Pallas body, and positions past the
// cache do not exist (-inf, weight 0).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;             // cache positions per block of pass 1
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;
#define ABSENT __int_as_float(0xff800000u)  // -inf: a position past the cache, weight 0

struct Strides {
  long long b, l, h;               // in elements; the head dim is contiguous
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
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

size_t smem_bytes(int G, int D) {
  return (size_t)(G * D + CH * (D + 1) + CH * D + G * CH) * sizeof(float);
}

// Pass 1. Partials are (n_chunks, B, H, D) for acc and (n_chunks, B, H) for m, l.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ lengths, int length, int B, int H, int G, int L,
               long long q_sb, long long q_sh, Strides ks, Strides vs, float scale,
               float* __restrict__ pacc, float* __restrict__ pm, float* __restrict__ pl) {
  constexpr int DK = D + 1;                // padded row stride of the K chunk
  extern __shared__ float smem[];
  float* qt = smem;                        // (G, D) q * scale
  float* kt = qt + G * D;                  // (CH, DK)
  float* vt = kt + CH * DK;                // (CH, D)
  float* st = vt + CH * D;                 // (G, CH) scores, then probabilities

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = lengths ? lengths[b] : length;
  const int p0 = c * CH;
  const size_t part = ((size_t)c * B + b) * H + (size_t)kvh * G;   // (chunk, lane, first head)
  if (n > 0 && p0 >= n) {
    for (int e = tid; e < G * D; e += THREADS) pacc[part * D + e] = 0.f;
    for (int g = tid; g < G; g += THREADS) { pm[part + g] = MASKED; pl[part + g] = 0.f; }
    return;
  }

  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    qt[e] = to_float(q[b * q_sb + (kvh * G + g) * q_sh + d]) * scale;
  }
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  for (int e = tid; e < CH * D / 4; e += THREADS) {
    const int r = e / (D / 4), col = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (p0 + r < L) {
      x = load4(kp + (p0 + r) * ks.l + col);
      y = load4(vp + (p0 + r) * vs.l + col);
    }
    float* kr = kt + r * DK + col;
    kr[0] = x.x; kr[1] = x.y; kr[2] = x.z; kr[3] = x.w;
    *reinterpret_cast<float4*>(vt + r * D + col) = y;
  }
  __syncthreads();

  // scores: a warp's lanes take neighbouring positions of one head
  for (int e = tid; e < G * CH; e += THREADS) {
    const int g = e / CH, j = e % CH, pos = p0 + j;
    const float* qg = qt + g * D;
    const float* kj = kt + j * DK;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(qg[d], kj[d], s);
    st[e] = pos >= L ? ABSENT : (pos < n ? s : MASKED);
  }
  __syncthreads();

  // softmax statistics of the chunk, one warp per head
  for (int g = warp; g < G; g += WARPS) {
    const float a = st[g * CH + lane], a2 = st[g * CH + lane + 32];
    const float m = warp_max(fmaxf(a, a2));
    const float p = expf(a - m), p2 = expf(a2 - m);
    st[g * CH + lane] = p;
    st[g * CH + lane + 32] = p2;
    const float l = warp_sum(p + p2);
    if (lane == 0) { pm[part + g] = m; pl[part + g] = l; }
  }
  __syncthreads();

  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    const float* pg = st + g * CH;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < CH; ++j) a = fmaf(pg[j], vt[j * D + d], a);
    pacc[part * D + e] = a;
  }
}

// Pass 2: one block of D threads per (lane, head).
template <typename T>
__global__ void merge_kernel(const float* __restrict__ pacc, const float* __restrict__ pm,
                             const float* __restrict__ pl, int n_chunks, int BH, int D,
                             int normalize, T* __restrict__ out, float* __restrict__ m_out,
                             float* __restrict__ l_out) {
  const int bh = blockIdx.x, d = threadIdx.x;
  float m = pm[bh];
  for (int s = 1; s < n_chunks; ++s) m = fmaxf(m, pm[(size_t)s * BH + bh]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_chunks; ++s) {
    const size_t i = (size_t)s * BH + bh;
    const float corr = expf(pm[i] - m);
    l += pl[i] * corr;
    a += pacc[i * D + d] * corr;
  }
  if (normalize) {
    store(out + (size_t)bh * D + d, a / fmaxf(l, 1e-30f));
  } else {
    store(out + (size_t)bh * D + d, a);
    if (d == 0) { m_out[bh] = m; l_out[bh] = l; }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const int* lengths, int length,
             int B, int H, int KvH, int L, const long long* st, float scale, float* pacc,
             float* pm, float* pl, void* out, float* m_out, float* l_out, int normalize,
             cudaStream_t stream) {
  auto kernel = partial_kernel<T, D>;
  const int G = H / KvH, n_chunks = (L + CH - 1) / CH;
  const size_t smem = smem_bytes(G, D);
  static size_t attribute = 48 * 1024;     // above 48 KB a kernel must ask
  if (smem > attribute) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attribute = smem;
  }
  const Strides ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  kernel<<<dim3(n_chunks, KvH, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, length, B, H, G, L, st[0], st[1], ks, vs,
      scale, pacc, pm, pl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<T><<<B * H, D, 0, stream>>>(pacc, pm, pl, n_chunks, B * H, D, normalize,
                                           (T*)out, m_out, l_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths, int length, int B,
           int H, int KvH, int L, int D, const long long* strides, float scale, int chunk,
           float* pacc, float* pm, float* pl, void* out, float* m_out, float* l_out,
           int normalize, void* stream) {
  // the caller sized the scratch for chunks of `chunk` positions
  if (B <= 0 || H <= 0 || KvH <= 0 || H % KvH || L <= 0 || chunk != CH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, lengths, length, B, H, KvH, L, strides, scale, pacc, pm, pl, out, m_out, l_out, normalize, s);
    case 32: return launch_d<T, 32>(q, k, v, lengths, length, B, H, KvH, L, strides, scale, pacc, pm, pl, out, m_out, l_out, normalize, s);
    case 64: return launch_d<T, 64>(q, k, v, lengths, length, B, H, KvH, L, strides, scale, pacc, pm, pl, out, m_out, l_out, normalize, s);
    case 128: return launch_d<T, 128>(q, k, v, lengths, length, B, H, KvH, L, strides, scale, pacc, pm, pl, out, m_out, l_out, normalize, s);
    case 256: return launch_d<T, 256>(q, k, v, lengths, length, B, H, KvH, L, strides, scale, pacc, pm, pl, out, m_out, l_out, normalize, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: q (B,H,D) with strides (batch, head); k and v (B,L,KvH,D) with
// strides (batch, position, head) — eight values in `strides`, q's two, then
// k's three, then v's three — head dim contiguous, rows 16-byte aligned.
// `lengths` is a device array of B int32 or null, and then `length` holds for
// every lane. Scratch: pacc (ceil(L/64), B, H, D), pm and pl (ceil(L/64), B, H),
// float32, for `chunk` = 64 (any other value is refused). Outputs: out (B,H,D) in the inputs' type; with normalize = 0 also
// m_out and l_out (B,H) float32. They launch both passes on `stream` and return
// cudaGetLastError().
extern "C" int launch_decode_attention_f32(const void* q, const void* k, const void* v,
                                           const int* lengths, int length, int B, int H,
                                           int KvH, int L, int D, const long long* strides,
                                           float scale, int chunk, float* pacc, float* pm,
                                           float* pl, void* out, float* m_out, float* l_out,
                                           int normalize, void* stream) {
  return launch<float>(q, k, v, lengths, length, B, H, KvH, L, D, strides, scale, chunk, pacc,
                       pm, pl, out, m_out, l_out, normalize, stream);
}

extern "C" int launch_decode_attention_bf16(const void* q, const void* k, const void* v,
                                            const int* lengths, int length, int B, int H,
                                            int KvH, int L, int D, const long long* strides,
                                            float scale, int chunk, float* pacc, float* pm,
                                            float* pl, void* out, float* m_out, float* l_out,
                                            int normalize, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, length, B, H, KvH, L, D, strides, scale, chunk,
                               pacc, pm, pl, out, m_out, l_out, normalize, stream);
}
