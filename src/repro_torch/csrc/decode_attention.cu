// Decode attention: one query token per (batch lane, head) against a KV cache,
// for float and bfloat16 inputs, with a length per lane or one for all.
//
// Replaces: repro/kernels/decode_attention.py:73, the `pallas_call` of
// `_decode_kernel` (grid (B, H, L/bk), the cache length innermost and
// sequential on the TPU, (acc, m, l) carried in VMEM scratch; `normalize=False`
// returns the unnormalised acc with (m, l) for `merge_partials`).
//
// Bound on this card: bytes.  Every cache row a lane attends to is read once,
// 2*KvH*D elements, for 4*H*D floating-point operations: about two operations
// per byte in bfloat16, far below the ~295 at which the tensor cores would
// become the limit.  At 4 lanes of a 1024-position cache of tinyllama (KvH 4,
// D 64) that is 4.2 MB, or 1.3 us at 3.35 TB/s: far less than a launch, so
// what a call costs is its launches, its host work and its latency.
//
// Design: one launch a call.  The cache is split into chunks of `chunk`
// positions (a multiple of 64 the wrapper picks from L and the SM count, so
// that the grid fills the card at a few lanes); one block per (chunk, group,
// lane) reads the chunk's K and V rows once for the query heads of its group
// (never replicated) and forms a partial (acc, m, l) per head.  A group is
// the G = H/KvH query heads of one KV head, or, where G is above 16, a tile of
// 16 of them (ceil(G/16) groups a KV head, each reading the rows again).
// Chunks at or past a lane's length exit at once and rows past it are not
// read (their weight exp(-1e30 - m) is 0).  A lane with length 0 masks every
// position at -1e30, so its weights are uniform over the cache, as in the
// Pallas body.  A chunk that is a lane's only one writes the output itself;
// otherwise each block stores its partial in a float32 workspace, fences, and
// counts itself in an atomic counter per (lane, group); the last block to
// arrive merges the partials by log-sum-exp (as `merge_partials` does),
// writes the output, and sets the counter back to 0 for the next call (or
// the next replay of a CUDA graph).
//
// bfloat16 (`decode_bf16_mma`): K and V arrive in shared memory as bf16 by
// cp.async, 16 bytes a thread, never widened.  The heads of a group are the
// rows of an m16n8k16 `mma.sync` tile (padded to 16 rows with zeros):
// each warp takes 16 positions at a time, S = Q K^T from ldmatrix fragments,
// an online softmax over its positions with row statistics reduced over the
// 4 threads of a row, P rounded to bf16 in registers as the A fragment of
// O += P V (V through ldmatrix.trans).  The four warps' partials merge in
// shared memory.  float32 (`decode_f32`), held to 2e-5: the CUDA cores; the
// score of a position is split over a team of lanes (4 dims a lane at a time)
// and summed by shuffles, then one warp per head forms the chunk's softmax and
// each thread sums P V for 4 dims of one head.  Scores are float32 with the
// masks of the Pallas body: positions at or past the length score -1e30,
// positions past the cache do not exist (-inf, weight 0).
#include "hopper.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 16;          // query heads a group: the rows of one mma tile
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
#define ABSENT __int_as_float(0xff800000u)  // -inf: a position past the cache, weight 0

}  // namespace

// What a launch needs, in one struct (the wrapper fills a ctypes twin).
struct DecodeArgs {
  const void* q;                   // (B,H,D)
  const void* k;                   // (B,L,KvH,D)
  const void* v;
  const int* lengths;              // B int32 on the device, or null: `length` for all
  void* out;                       // (B,H,D) contiguous, in the inputs' type
  float* m_out;                    // (B,H) with normalize = 0, else unused
  float* l_out;
  float* partials;                 // workspace: (groups, n_chunks, min(G, 16)*D + 32) float32
  int* counters;                   // workspace: one int32 a group, 0 between calls
  long long q_sb, q_sh;            // strides in elements; the head dim is contiguous
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int length, B, H, KvH, L, D, chunk, n_chunks, normalize;
  float scale;
};

namespace {

// The query heads a block takes: a tile of at most MAX_G of the G = H/KvH heads
// of one KV head (blockIdx.y = KV head * tiles + tile).
struct Group {
  int kvh, g0, n;                  // KV head, its first query head in the tile, heads in it
};
__device__ __forceinline__ Group group_of(const DecodeArgs& a) {
  const int G = a.H / a.KvH, tiles = (G + MAX_G - 1) / MAX_G;
  const int kvh = blockIdx.y / tiles, g0 = blockIdx.y % tiles * MAX_G;
  return {kvh, g0, min(MAX_G, G - g0)};
}

__host__ __device__ __forceinline__ int active_chunks(int n, int L, int chunk, int n_chunks) {
  return n > 0 ? min((min(n, L) + chunk - 1) / chunk, n_chunks) : n_chunks;
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__device__ __forceinline__ void write_out(const DecodeArgs& a, size_t bh, int d, float acc,
                                          float m, float l) {
  T* out = static_cast<T*>(a.out) + bh * D + d;
  if (a.normalize) {
    store(out, acc / fmaxf(l, 1e-30f));
  } else {
    store(out, acc);
    if (d == 0) { a.m_out[bh] = m; a.l_out[bh] = l; }
  }
}

// The block's partial from NSUB partials in shared memory (sub_m, sub_l
// (NSUB, 16); sub_acc (NSUB, 16, D)) of the G heads of its group; then the
// output, directly when the chunk is the lane's only one, else by the last
// block of the (lane, group) from the workspace, where a chunk's partial is
// acc (min(H/KvH, 16), D) then m and l, 16 slots each.  `wgt` has room for
// 2 * n_chunks * 16 + 32 floats.
template <typename T, int D, int NSUB>
__device__ void finish(const DecodeArgs& a, const Group& grp, int active, const float* sub_m,
                       const float* sub_l, const float* sub_acc, float* wgt) {
  __shared__ int last;
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x, G = grp.n;
  const int pair = b * gridDim.y + blockIdx.y;
  const int heads = a.H / a.KvH;
  const size_t PART = (size_t)min(heads, MAX_G) * D + 32;
  const size_t head0 = (size_t)b * a.H + (size_t)grp.kvh * heads + grp.g0;
  float* const base = a.partials + (size_t)pair * a.n_chunks * PART;
  const bool alone = active == 1;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float m = sub_m[g];
#pragma unroll
    for (int s = 1; s < NSUB; ++s) m = fmaxf(m, sub_m[s * 16 + g]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int s = 0; s < NSUB; ++s) {
      const float corr = exp2f((sub_m[s * 16 + g] - m) * LOG2E);
      l += sub_l[s * 16 + g] * corr;
      acc += sub_acc[(s * 16 + g) * D + d] * corr;
    }
    if (alone) {
      write_out<T, D>(a, head0 + g, d, acc, m, l);
    } else {
      float* part = base + c * PART;
      part[e] = acc;
      if (d == 0) { part[G * D + g] = m; part[G * D + 16 + g] = l; }
    }
  }
  if (alone) return;
  __syncthreads();                         // the block's partial is written; thread 0's
  if (tid == 0) {                          // fence makes it visible before it counts
    __threadfence();
    last = atomicAdd(a.counters + pair, 1) == active - 1;
  }
  __syncthreads();
  if (!last) return;
  if (tid == 0) a.counters[pair] = 0;      // ready for the next call
  __threadfence();

  // every chunk's (m, l) at once; then per head the merged maximum, each
  // chunk's weight (in place of its m) and the merged sum
  float* cm = wgt;
  float* cl = cm + a.n_chunks * 16;
  float* gm = cl + a.n_chunks * 16;
  float* gl = gm + 16;
  for (int i = tid; i < active * G; i += THREADS) {
    const int cc = i / G, g = i % G;
    cm[cc * 16 + g] = __ldcg(base + cc * PART + G * D + g);
    cl[cc * 16 + g] = __ldcg(base + cc * PART + G * D + 16 + g);
  }
  __syncthreads();
  if (tid < G) {
    float m = ABSENT, l = 0.f;
    for (int cc = 0; cc < active; ++cc) m = fmaxf(m, cm[cc * 16 + tid]);
    for (int cc = 0; cc < active; ++cc) {
      const float wt = exp2f((cm[cc * 16 + tid] - m) * LOG2E);
      cm[cc * 16 + tid] = wt;
      l += cl[cc * 16 + tid] * wt;
    }
    gm[tid] = m;
    gl[tid] = l;
  }
  __syncthreads();
  // the merged accumulator, 4 dims a thread, the chunks' loads in flight together
  for (int e = tid * 4; e < G * D; e += THREADS * 4) {
    const int g = e / D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int cc = 0; cc < active; ++cc) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(base + cc * PART + e));
      const float wt = cm[cc * 16 + g];
      acc.x = fmaf(x.x, wt, acc.x); acc.y = fmaf(x.y, wt, acc.y);
      acc.z = fmaf(x.z, wt, acc.z); acc.w = fmaf(x.w, wt, acc.w);
    }
    const int d = e % D;
    write_out<T, D>(a, head0 + g, d, acc.x, gm[g], gl[g]);
    write_out<T, D>(a, head0 + g, d + 1, acc.y, gm[g], gl[g]);
    write_out<T, D>(a, head0 + g, d + 2, acc.z, gm[g], gl[g]);
    write_out<T, D>(a, head0 + g, d + 3, acc.w, gm[g], gl[g]);
  }
}

// -- bfloat16 on the tensor cores ------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory: Q (16, D+8) bf16, then K and V (chunk, D+8) bf16, reused for
// the four warps' partials, then the merge's weights
template <int D>
size_t bf16_smem(int chunk, int n_chunks) {
  const size_t kv = (size_t)2 * chunk * (D + 8) * 2, subs = (size_t)WARPS * 16 * (D + 2) * 4;
  return (size_t)16 * (D + 8) * 2 + (kv > subs ? kv : subs) + ((size_t)n_chunks * 32 + 32) * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_bf16_mma(const DecodeArgs a) {
  constexpr int DP = D + 8;                // padded row: ldmatrix reads free of conflicts
  extern __shared__ __align__(16) uint8_t dsm[];
  const int C = a.chunk, c = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const Group grp = group_of(a);
  const int G = grp.n, kvh = grp.kvh;
  const int n = a.lengths ? a.lengths[b] : a.length;
  const int active = active_chunks(n, a.L, C, a.n_chunks);
  if (c >= active) return;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(dsm);
  __nv_bfloat16* ks = qs + 16 * DP;
  __nv_bfloat16* vs = ks + C * DP;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                           (long long)(kvh * (a.H / a.KvH) + grp.g0) * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // K and V by cp.async, then Q by plain loads while they are in flight
  const int p0 = c * C;
  const int rows = min(a.L, n > 0 ? n : a.L) - p0;   // rows of the chunk to read
  for (int e = tid; e < C * (D / 8); e += THREADS) {
    const int r = e / (D / 8), col = (e % (D / 8)) * 8;
    if (r < rows) {
      cp_async16(smem_u32(ks + r * DP + col), k + (long long)(p0 + r) * a.k_sl + col);
      cp_async16(smem_u32(vs + r * DP + col), v + (long long)(p0 + r) * a.v_sl + col);
    } else {
      *reinterpret_cast<uint4*>(ks + r * DP + col) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vs + r * DP + col) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = tid; e < 16 * (D / 8); e += THREADS) {
    const int r = e / (D / 8), col = (e % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) x = *reinterpret_cast<const uint4*>(q + r * a.q_sh + col);
    *reinterpret_cast<uint4*>(qs + r * DP + col) = x;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // accumulator e of an 8-wide tile: row l/4 + 8*(e/2), column 2*(l%4) + e%2
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m[2] = {MASKED, MASKED}, lsum[2] = {0.f, 0.f};

  for (int j = w; j < C / 16; j += WARPS) {
    const int s0 = j * 16;                 // this step's 16 positions of the chunk
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, smem_u32(qs + (l % 16) * DP + kk * 16 + (l / 16) * 8));
      ldsm_x4(kb, smem_u32(ks + (s0 + l % 8 + (l / 16) * 8) * DP + kk * 16 + ((l / 8) % 2) * 8));
      mma16816(s[0], qa, kb[0], kb[1]);
      mma16816(s[1], qa, kb[2], kb[3]);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + s0 + t * 8 + 2 * (l % 4) + (e & 1);
        const float x = pos >= a.L ? ABSENT : (pos < n ? s[t][e] * a.scale : MASKED);
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      lsum[r] *= corr[r];
    }
    // P as the A fragment: a0..a3 = (row, tile 0), (row + 8, tile 0), (row, tile 1), ...
    uint32_t pa[4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x0 = exp2f((s[t][2 * r] - m[r]) * LOG2E);
        const float x1 = exp2f((s[t][2 * r + 1] - m[r]) * LOG2E);
        lsum[r] += x0 + x1;
        __nv_bfloat162 pair = __floats2bfloat162_rn(x0, x1);
        pa[t * 2 + r] = *reinterpret_cast<uint32_t*>(&pair);
      }
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= corr[e >> 1];
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t vb[4];
      ldsm_x4_t(vb, smem_u32(vs + (s0 + l % 8 + ((l / 8) % 2) * 8) * DP + dt * 16 + (l / 16) * 8));
      mma16816(acc[2 * dt], pa, vb[0], vb[1]);
      mma16816(acc[2 * dt + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }

  __syncthreads();                         // K and V are consumed: their room takes the partials
  float* sub_m = reinterpret_cast<float*>(ks);
  float* sub_l = sub_m + WARPS * 16;
  float* sub_acc = sub_l + WARPS * 16;
  if (l % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sub_m[w * 16 + l / 4 + 8 * r] = m[r];
      sub_l[w * 16 + l / 4 + 8 * r] = lsum[r];
    }
  }
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sub_acc[(w * 16 + l / 4 + 8 * (e >> 1)) * D + t * 8 + 2 * (l % 4) + (e & 1)] = acc[t][e];
  __syncthreads();
  const size_t kv = (size_t)2 * C * DP * 2, subs = (size_t)WARPS * 16 * (D + 2) * 4;
  float* wgt = reinterpret_cast<float*>(dsm + 16 * DP * 2 + (kv > subs ? kv : subs));
  finish<__nv_bfloat16, D, WARPS>(a, grp, active, sub_m, sub_l, sub_acc, wgt);
}

// -- float32 on the CUDA cores ----------------------------------------------------

// shared memory: q * scale (16, D), K (chunk, D+4), V (chunk, D), scores
// (16, chunk), the block's partial, the merge's weights (floats)
template <int D>
size_t f32_smem(int chunk, int n_chunks) {
  return ((size_t)16 * D + (size_t)chunk * (D + 4) + (size_t)chunk * D + 16 * chunk +
          32 + 16 * D + (size_t)n_chunks * 32 + 32) * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
decode_f32(const DecodeArgs a) {
  constexpr int DK = D + 4;
  constexpr int TEAM = D / 4 < 32 ? D / 4 : 32;    // lanes that share a score, 4 dims each
  constexpr int PER_WARP = 32 / TEAM;               // positions a warp scores at once
  extern __shared__ __align__(16) float fsm[];
  const int C = a.chunk, c = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const Group grp = group_of(a);
  const int G = grp.n, kvh = grp.kvh;
  const int n = a.lengths ? a.lengths[b] : a.length;
  const int active = active_chunks(n, a.L, C, a.n_chunks);
  if (c >= active) return;
  float* qs = fsm;
  float* ks = qs + 16 * D;
  float* vs = ks + C * DK;
  float* sc = vs + C * D;
  float* sub_m = sc + 16 * C;
  float* sub_l = sub_m + 16;
  float* sub_acc = sub_l + 16;
  float* wgt = sub_acc + 16 * D;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb +
                   (long long)(kvh * (a.H / a.KvH) + grp.g0) * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // K and V by cp.async, then q * scale by plain loads while they are in flight
  const int p0 = c * C;
  const int rows = min(a.L, n > 0 ? n : a.L) - p0;
  for (int e = tid; e < C * (D / 4); e += THREADS) {
    const int r = e / (D / 4), col = (e % (D / 4)) * 4;
    if (r < rows) {
      cp_async16(smem_u32(ks + r * DK + col), k + (long long)(p0 + r) * a.k_sl + col);
      cp_async16(smem_u32(vs + r * D + col), v + (long long)(p0 + r) * a.v_sl + col);
    } else {
      *reinterpret_cast<float4*>(ks + r * DK + col) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vs + r * D + col) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = tid; e < G * (D / 4); e += THREADS) {
    const int g = e / (D / 4), d = (e % (D / 4)) * 4;
    float4 x = *reinterpret_cast<const float4*>(q + g * a.q_sh + d);
    x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    *reinterpret_cast<float4*>(qs + g * D + d) = x;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // scores: a team of TEAM lanes per position, each 4 dims at a time, with
  // its dims of every head's q in registers (zeros past G)
  constexpr int NK = D / (4 * TEAM);
  const int member = l % TEAM;
  float4 qr[MAX_G][NK];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int i = 0; i < NK; ++i)
      qr[g][i] = g < G ? *reinterpret_cast<const float4*>(qs + g * D + (member + TEAM * i) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = w * PER_WARP + l / TEAM; p < C; p += WARPS * PER_WARP) {
    float4 kv[NK];
#pragma unroll
    for (int i = 0; i < NK; ++i)
      kv[i] = *reinterpret_cast<const float4*>(ks + p * DK + (member + TEAM * i) * 4);
    float x[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      x[g] = 0.f;
#pragma unroll
      for (int i = 0; i < NK; ++i)
        x[g] = fmaf(qr[g][i].w, kv[i].w, fmaf(qr[g][i].z, kv[i].z,
               fmaf(qr[g][i].y, kv[i].y, fmaf(qr[g][i].x, kv[i].x, x[g]))));
    }
    // every head's sum, those past G (zeros) too: a shuffle under a test of G
    // is a branch of its own, and the sums would no longer interleave
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) x[g] += __shfl_xor_sync(0xffffffffu, x[g], o);
    const int pos = p0 + p;
    if (member == 0) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) sc[g * C + p] = pos >= a.L ? ABSENT : (pos < n ? x[g] : MASKED);
    }
  }
  __syncthreads();

  // the chunk's softmax statistics, one warp per head
  for (int g = w; g < G; g += WARPS) {
    float mx = ABSENT;
    for (int j = l; j < C; j += 32) mx = fmaxf(mx, sc[g * C + j]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int j = l; j < C; j += 32) {
      const float p = expf(sc[g * C + j] - mx);
      sc[g * C + j] = p;
      s += p;
    }
    s = warp_sum(s);
    if (l == 0) { sub_m[g] = mx; sub_l[g] = s; }
  }
  __syncthreads();

  // P V: a thread owns 4 dims and a share of the heads, and reads each row of
  // V once for all of them
  constexpr int GROUPS = D / 4, SETS = THREADS / GROUPS > 0 ? THREADS / GROUPS : 1;
  constexpr int PER_SET = (MAX_G + SETS - 1) / SETS;
  const int d4 = (tid % GROUPS) * 4, set = tid / GROUPS;
  float4 o[PER_SET];
#pragma unroll
  for (int u = 0; u < PER_SET; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (set < SETS) {
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(vs + j * D + d4);
#pragma unroll
      for (int u = 0; u < PER_SET; ++u) {
        const int g = set + u * SETS;
        if (g < G) {
          const float p = sc[g * C + j];
          o[u].x = fmaf(p, x.x, o[u].x); o[u].y = fmaf(p, x.y, o[u].y);
          o[u].z = fmaf(p, x.z, o[u].z); o[u].w = fmaf(p, x.w, o[u].w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < PER_SET; ++u) {
      const int g = set + u * SETS;
      if (g < G) *reinterpret_cast<float4*>(sub_acc + g * D + d4) = o[u];
    }
  }
  __syncthreads();
  finish<float, D, 1>(a, grp, active, sub_m, sub_l, sub_acc, wgt);
}

template <typename T, int D>
int launch_d(const DecodeArgs& a, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  auto kernel = bf16 ? decode_bf16_mma<D> : decode_f32<D>;
  const size_t smem = bf16 ? bf16_smem<D>(a.chunk, a.n_chunks) : f32_smem<D>(a.chunk, a.n_chunks);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static size_t attribute = 48 * 1024;     // above 48 KB a kernel must ask
  if (smem > attribute) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attribute = smem;
  }
  const int tiles = (a.H / a.KvH + MAX_G - 1) / MAX_G;
  kernel<<<dim3(a.n_chunks, a.KvH * tiles, a.B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const DecodeArgs* a, void* stream) {
  if (a->B <= 0 || a->H <= 0 || a->KvH <= 0 || a->H % a->KvH || a->L <= 0 || a->chunk <= 0 ||
      a->chunk % 64 || a->n_chunks != (a->L + a->chunk - 1) / a->chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (a->D) {
    case 16: return launch_d<T, 16>(*a, s);
    case 32: return launch_d<T, 32>(*a, s);
    case 64: return launch_d<T, 64>(*a, s);
    case 128: return launch_d<T, 128>(*a, s);
    case 256: return launch_d<T, 256>(*a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launchers: one kernel launch on `stream` for the call `a` describes (see
// DecodeArgs): rows of q, k, v 16-byte aligned (strides of whole 16 bytes),
// `chunk` a multiple of 64 with n_chunks = ceil(L / chunk), the workspace
// sized for them (B * KvH * ceil(G / 16) groups, G = H/KvH) and its counters 0.  They return
// cudaGetLastError() (cudaErrorInvalidValue for a call they do not take).
extern "C" int launch_decode_attention_f32(const DecodeArgs* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int launch_decode_attention_bf16(const DecodeArgs* a, void* stream) {
  return launch<__nv_bfloat16>(a, stream);
}
