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

#include "hopper.cuh"

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

// S4, the backward: g_t = dh_t + a_{t+1} g_{t+1} from g_S = 0 (a_S = 0),
// db_t = g_t, da_t = g_t h_{t-1} (da_0 = 0). Bound on this card: bytes, 20 a
// step (a, h and dh read, da and db written): 0.100 ms at RecurrentGemma's
// train shape (2, 2048, 4096).
//
// Design: the sequence is cut into segments of SEG = 8 x STEPS steps; a tile
// is (segment, lane, 32 channels), a warp's 32 threads on neighbouring
// channels, so each load and store of a step is one 128-byte line. Tiles are
// numbered from the end of the sequence and handed out in that order by an
// atomic counter: a persistent grid (as many blocks of 8 warps as fit the
// card when it is idle) claims them, each block two turns ahead. While it
// works on one tile, its cp.async copies of the next tile's a_{t+1}, dh_t and
// h_{t-1} (h loaded with a and dh, STEPS of each a thread) fill the other
// half of a double buffer in shared memory. On a tile each warp composes its
// steps into one affine map g -> A g + B, the warps' maps make the tile's,
// and the tile learns the g its segment starts from by a decoupled look-back:
// it publishes its map (status 1), reads the maps of the segments after it
// back to the first whose g is known (status 2), applies them from there, and
// publishes its own g (status 2); then each warp replays its steps from
// shared memory and stores da and db. A tile waits only on tiles of smaller
// number, and every tile of smaller number has been claimed by a block that
// is running: the smallest unfinished tile is always the one its block is
// working on, so the walk finishes however few of the grid's blocks the card
// makes resident (another kernel may hold SMs). Every g is the same chain of
// fmaf's whichever statuses a block finds: deterministic. The counter and the
// statuses (zeroed before each launch) and the maps live in a workspace the
// caller gives; a wait that outlasts some seconds (a fault) traps.
constexpr int BWD_STEPS = 16;                         // steps per warp per tile
constexpr int BWD_SEG = WARPS * BWD_STEPS;            // steps per tile
constexpr int BWD_STAGE = 3 * BWD_SEG * 32;           // floats of one tile's loads
constexpr int BWD_SMEM = 2 * BWD_STAGE * 4;           // bytes: two tiles' loads
constexpr long long SPIN_LIMIT = 1LL << 26;

__device__ __forceinline__ int wait_status(const int* p) {
  int s;
  long long spins = 0;
  while ((s = *(const volatile int*)p) == 0) {
    if (++spins > SPIN_LIMIT) __trap();
    __nanosleep(64);
  }
  return s;
}

struct BwdArgs {
  const float *a, *h, *dh;
  float *da, *db;
  int Bn, S, D, dtiles, nseg, ntiles;
  long long a_sb, a_ss, h_sb, h_ss, g_sb, g_ss, da_sb, da_ss, db_sb, db_ss;
  int* status;
  int* next;                    // the tile counter
  float* maps;
};

struct BwdTile {
  int seg, lb, d, s1;           // s1: this warp's steps are s1 - 1 down to s1 - STEPS
  bool on;
};

__device__ __forceinline__ BwdTile bwd_tile(const BwdArgs& p, int i, int warp, int lane) {
  const int rev = i / (p.Bn * p.dtiles);              // 0: the segment at the end
  const int rest = i - rev * p.Bn * p.dtiles;
  BwdTile t;
  t.seg = p.nseg - 1 - rev;
  t.lb = rest / p.dtiles;
  t.d = (rest - t.lb * p.dtiles) * 32 + lane;
  t.on = t.d < p.D;
  t.s1 = (t.seg + 1) * BWD_SEG - warp * BWD_STEPS;
  return t;
}

// this thread's words of a stage: a_{t+1}, dh_t, h_{t-1} of step i
__device__ __forceinline__ float* bwd_word(float* stage, int arr, int warp, int i, int lane) {
  return stage + ((arr * WARPS + warp) * BWD_STEPS + i) * 32 + lane;
}

// cp.async of tile i's loads into `stage`, one group; zeros where masked
__device__ __forceinline__ void bwd_load(const BwdArgs& p, float* stage, int i, int warp,
                                         int lane) {
  const BwdTile tl = bwd_tile(p, i, warp, lane);
  const float* ap = p.a + tl.lb * p.a_sb + tl.d;
  const float* gp = p.dh + tl.lb * p.g_sb + tl.d;
  const float* hp = p.h + tl.lb * p.h_sb + tl.d;
#pragma unroll 8
  for (int k = 0; k < BWD_STEPS; ++k) {
    const int t = tl.s1 - 1 - k;
    const bool ok = tl.on && t < p.S;
    const bool an = ok && t + 1 < p.S, hn = ok && t > 0;
    cp_async4(smem_u32(bwd_word(stage, 0, warp, k, lane)), an ? ap + (t + 1) * p.a_ss : p.a,
              an ? 4 : 0);
    cp_async4(smem_u32(bwd_word(stage, 1, warp, k, lane)), ok ? gp + t * p.g_ss : p.dh,
              ok ? 4 : 0);
    cp_async4(smem_u32(bwd_word(stage, 2, warp, k, lane)), hn ? hp + (t - 1) * p.h_ss : p.h,
              hn ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) float bwd_smem[];
  __shared__ float seg_a[WARPS][32], seg_b[WARPS][32], carry[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ int claim[2];                        // the tiles of this block's next turns
  if (threadIdx.x == 0) {
    const int c = atomicAdd(p.next, 2);
    claim[0] = c;
    claim[1] = c + 1;
  }
  __syncthreads();
  int i = claim[0];
  if (i < p.ntiles) bwd_load(p, bwd_smem, i, warp, lane);
  for (int k = 0; i < p.ntiles; ++k) {
    float* stage = bwd_smem + (k & 1) * BWD_STAGE;
    const int next = claim[(k + 1) & 1];
    if (next < p.ntiles) {                        // the next tile's loads go out first
      bwd_load(p, bwd_smem + ((k + 1) & 1) * BWD_STAGE, next, warp, lane);
    }
    // the tile of turn k + 2, claimed while this turn's loads land
    const int later = threadIdx.x == 0 ? atomicAdd(p.next, 1) : 0;
    if (next < p.ntiles) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    // each thread reads only the words its own copies wrote: no barrier
    const BwdTile tl = bwd_tile(p, i, warp, lane);
    float A = 1.f, Bs = 0.f;                      // this warp's steps as g -> A g + Bs
#pragma unroll 8
    for (int j = 0; j < BWD_STEPS; ++j) {
      const float av = tl.on && tl.s1 - 1 - j < p.S ? *bwd_word(stage, 0, warp, j, lane) : 1.f;
      Bs = fmaf(av, Bs, *bwd_word(stage, 1, warp, j, lane));
      A *= av;
    }
    seg_a[warp][lane] = A;
    seg_b[warp][lane] = Bs;
    __syncthreads();                              // every thread has read claim[k & 1]
    if (warp == 0) {
      if (lane == 0) claim[k & 1] = later;
      float At = 1.f, Bt = 0.f;                   // the tile's map, its warps from the latest
      for (int w = 0; w < WARPS; ++w) {
        Bt = fmaf(seg_a[w][lane], Bt, seg_b[w][lane]);
        At *= seg_a[w][lane];
      }
      // record of (segment sg, this tile's lane and channels), then its channel
      const long long tile0 = (long long)tl.lb * p.nseg * p.dtiles + (tl.d - lane) / 32;
      auto rec = [&](int sg) { return (tile0 + (long long)sg * p.dtiles) * 32 + lane; };
      float g = 0.f;                              // g at the first step after the segment
      if (tl.seg < p.nseg - 1) {
        if (tl.seg > 0) {
          p.maps[rec(tl.seg) * 3] = At;
          p.maps[rec(tl.seg) * 3 + 1] = Bt;
          __threadfence();
          *(volatile int*)&p.status[rec(tl.seg)] = 1;
        }
        int m = tl.seg + 1;
        while (wait_status(&p.status[rec(m)]) != 2) ++m;
        __threadfence();
        g = __ldcg(&p.maps[rec(m) * 3 + 2]);
        for (int sg = m - 1; sg > tl.seg; --sg)
          g = fmaf(__ldcg(&p.maps[rec(sg) * 3]), g, __ldcg(&p.maps[rec(sg) * 3 + 1]));
      }
      if (tl.seg > 0) {
        p.maps[rec(tl.seg) * 3 + 2] = fmaf(At, g, Bt);
        __threadfence();
        *(volatile int*)&p.status[rec(tl.seg)] = 2;
      }
      carry[lane] = g;
    }
    __syncthreads();
    float gv = carry[lane];
    for (int w = 0; w < warp; ++w) gv = fmaf(seg_a[w][lane], gv, seg_b[w][lane]);
    float* dap = p.da + tl.lb * p.da_sb + tl.d;
    float* dbp = p.db + tl.lb * p.db_sb + tl.d;
#pragma unroll 8
    for (int j = 0; j < BWD_STEPS; ++j) {
      const int t = tl.s1 - 1 - j;
      if (tl.on && t < p.S) {
        gv = fmaf(*bwd_word(stage, 0, warp, j, lane), gv, *bwd_word(stage, 1, warp, j, lane));
        dbp[t * p.db_ss] = gv;
        dap[t * p.da_ss] = t > 0 ? gv * *bwd_word(stage, 2, warp, j, lane) : 0.f;
      }
    }
    __syncthreads();                              // seg_a, seg_b, carry, claim: next turn
    i = next;
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


// Bytes of the backward's workspace: a status word per channel and tile, the
// tile counter (16 bytes), then three floats per channel and tile (the map's
// A and B, the g the segment starts from).
extern "C" long long rglru_scan_bwd_workspace_bytes(int Bn, int S, int D) {
  const long long tiles = (long long)Bn * ((S + BWD_SEG - 1) / BWD_SEG) * ((D + 31) / 32);
  return tiles * 32 * 4 * 4 + 16;
}

namespace {

// The backward's grid on a device: its SMs times the blocks one SM holds,
// found once per device (with the shared-memory attribute set there).
constexpr int MAX_DEVICES = 64;
int bwd_grid_of[MAX_DEVICES];

cudaError_t bwd_grid(int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bwd_grid_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(rglru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BWD_SMEM);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rglru_bwd_kernel, THREADS,
                                                        BWD_SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    bwd_grid_of[dev] = sms * per_sm;
  }
  *grid = bwd_grid_of[dev];
  return cudaSuccess;
}

}  // namespace

// Launcher of the backward: a, h (the forward's output), dh, da and db (B,S,D),
// each given by its pointer and its strides over (lane, position) — ten
// values in `strides`, a's, h's, dh's, da's, db's — with D contiguous, and a
// workspace of `work_bytes` (at least rglru_scan_bwd_workspace_bytes) whose
// statuses and counter it zeroes first. The grid is as many blocks as the
// idle card holds at once, at most one a tile. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int launch_rglru_scan_bwd_f32(const float* a, const float* h, const float* dh,
                                         float* da, float* db, int Bn, int S, int D,
                                         const long long* st, void* work, long long work_bytes,
                                         void* stream) {
  if (Bn <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long need = rglru_scan_bwd_workspace_bytes(Bn, S, D);
  if (work == nullptr || work_bytes < need) return (int)cudaErrorInvalidValue;
  const long long status_bytes = (need - 16) / 4;
  BwdArgs p{a, h, dh, da, db, Bn, S, D, (D + 31) / 32, (S + BWD_SEG - 1) / BWD_SEG, 0,
            st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
            (int*)work, (int*)((char*)work + status_bytes),
            (float*)((char*)work + status_bytes + 16)};
  p.ntiles = Bn * p.nseg * p.dtiles;
  int grid = 0;
  cudaError_t e = bwd_grid(&grid);
  if (e == cudaSuccess) e = cudaMemsetAsync(work, 0, status_bytes + 16, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  rglru_bwd_kernel<<<p.ntiles < grid ? p.ntiles : grid, THREADS, BWD_SMEM,
                     (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
