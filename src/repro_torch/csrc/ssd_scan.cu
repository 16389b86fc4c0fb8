// Mamba-2 SSD chunked scan (state-space duality) in float32.
//
// Replaces: repro/kernels/ssd_scan.py:71, the `pallas_call` of `_ssd_kernel`
// (grid (B, H, nc), the chunk dimension innermost and sequential on the TPU,
// the state h (N, P) carried in VMEM scratch from one chunk to the next).
//
// Per chunk of Q positions, with cum = cumsum(dA) inside the chunk:
//   y = ((C B^T) o tril(exp(cum_q - cum_s))) x  +  (C o exp(cum)) h
//   h <- exp(cum_last) h + (B o exp(cum_last - cum))^T x
// x (B,H,S,P) and dA (B,H,S) per head; B and C (B,S,N) shared by the heads.
//
// Bound on this card: operations. Counted as the TPU kernel does the work,
// a chunk takes 2 Q^2 N (C B^T) + 2 Q^2 P + 2 Q N P + 2 Q N P operations; at the
// Mamba-2 prefill (B 4, S 2048, H 48, P 64, N 128, Q 256) that is 51.5 GFLOP,
// 0.77 ms at 67 TFLOP/s float32, against 211 MB of inputs and outputs, or
// 0.063 ms at 3.35 TB/s.
//
// Design: one block of 256 threads per (tile of up to 64 columns of P, head,
// lane). The TPU's sequential chunk dimension is a loop inside the block;
// h (N, 64) lives in shared memory from zero. A chunk is cut in tiles of 64
// positions, and the (Q, Q) score matrix is never held whole: for each query
// tile the block forms (C h) o exp(cum) first, then walks the source tiles up
// to the diagonal, each time forming a (64, 64) score tile C_q B_s^T, weighting
// it by exp(cum_q - cum_s) where s <= q (exp is never evaluated above the
// diagonal, where it may overflow: those scores are 0), and adding the tile
// times x_s. While it walks the last query tile, which meets every source tile,
// it also sums (B_s o w_s)^T x_s for the state update into registers; the state
// is replaced once every query tile has read it. Every product is a 4x4 (8x4
// for the state) register tile per thread over operands in shared memory.
// The cumulative decay logs are summed and differenced in double precision
// before each exp: in float32, cum_q at Mamba-2's widths reaches some -64
// within a chunk of 256, and its rounding (ulp 7.6e-6) becomes a relative
// error of every decay, even between neighbouring positions, that alone puts
// a float32 chunked scan outside 2e-4 of the step-by-step recurrence at that
// shape; differences of doubles are exact to far below that. The products
// stay float32. A ragged tail (S not a multiple of Q) is masked here:
// positions at or past S are not read, count as zero inputs with dA = 0, and
// are not stored, which is the function of the reference's zero padding. The
// tensor cores (wgmma), sharing C B^T across heads, and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int T = 64;              // positions of a query or source tile; columns of a P tile
constexpr int TS = T + 4;          // padded row stride of the (., 64) tiles, in floats
constexpr int MAX_N = 128;         // state rows: 8 per thread row of the 16x16 thread grid

struct Str3 {
  long long b, h, s;               // (lane, head, position), in elements
};
struct Str2 {
  long long b, s;                  // (lane, position), in elements
};

// the padded stride of C's rows in shared memory: odd, so that the two rows a
// warp reads at once fall in different banks
__host__ __device__ inline int c_stride(int N) { return N + 1; }

__host__ __device__ inline size_t smem_floats(int N, int Q) {
  return (size_t)N * TS + (size_t)N * TS + 2 * (size_t)T * TS + 2 * (size_t)Q +
         (size_t)T * c_stride(N) + T;
}

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dA,
           const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
           int S, int P, int N, int Q, Str3 xs, Str3 das, Str2 bs, Str2 cs, Str3 ys) {
  const int CN = c_stride(N);
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);   // (N, TS)  the state, this tile of P
  float* bt = hs + N * TS;                       // (N, TS)  B of the source tile, transposed
  float* xt = bt + N * TS;                       // (T, TS)  x of the source tile
  float* st = xt + T * TS;                       // (T, TS)  decay-weighted scores
  double* cum = reinterpret_cast<double*>(st + T * TS);  // (Q) cumsum of dA in the chunk
  float* ct = reinterpret_cast<float*>(cum + Q); // (T, CN)  C of the query tile
  float* wv = ct + T * CN;                       // (T)      exp(cum_last - cum_s)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;        // 16 x 16 threads; rows ty + 16 i, cols 4 tx + j
  const int p0 = blockIdx.x * T, PT = min(T, P - p0);
  const int h = blockIdx.y, b = blockIdx.z;
  const float* xp = x + b * xs.b + h * xs.h + p0;
  const float* dp = dA + b * das.b + h * das.h;
  const float* bp = Bm + b * bs.b;
  const float* cp = Cm + b * cs.b;
  float* yp = y + b * ys.b + h * ys.h + p0;

  for (int e = tid; e < N * TS; e += THREADS) hs[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int Qv = min(Q, S - c0);               // positions of this chunk that exist
    __syncthreads();                             // the previous chunk is done with cum and hs
    if (warp == 0) {
      double carry = 0.0;
      for (int base = 0; base < Qv; base += 32) {
        double v = base + lane < Qv ? (double)dp[(c0 + base + lane) * das.s] : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (base + lane < Qv) cum[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double last = cum[Qv - 1];
    const int n_tiles = (Qv + T - 1) / T;

    float dh[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[i][j] = 0.f;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * T;
      const bool last_tile = qt == n_tiles - 1;
      __syncthreads();                           // ct is free
      for (int e = tid; e < T * N; e += THREADS) {
        const int r = e / N, k = e % N;
        ct[r * CN + k] = q0 + r < Qv ? cp[(c0 + q0 + r) * cs.s + k] : 0.f;
      }
      __syncthreads();

      // inter-chunk part: (C_q h) o exp(cum_q)
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < N; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + k * TS + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ct[(ty + 16 * i) * CN + k];
          acc[i][0] = fmaf(a, hv.x, acc[i][0]);
          acc[i][1] = fmaf(a, hv.y, acc[i][1]);
          acc[i][2] = fmaf(a, hv.z, acc[i][2]);
          acc[i][3] = fmaf(a, hv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        const float g = q < Qv ? expf((float)cum[q]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g;
      }

      // intra-chunk part, source tiles up to the diagonal
      for (int s_t = 0; s_t <= qt; ++s_t) {
        const int s0 = s_t * T;
        __syncthreads();                         // bt, xt, st and wv are free
        for (int e = tid; e < T * N; e += THREADS) {
          const int s = e / N, k = e % N;
          bt[k * TS + s] = s0 + s < Qv ? bp[(c0 + s0 + s) * bs.s + k] : 0.f;
        }
        for (int e = tid; e < T * T; e += THREADS) {
          const int s = e / T, c = e % T;
          xt[s * TS + c] = (s0 + s < Qv && c < PT) ? xp[(c0 + s0 + s) * xs.s + c] : 0.f;
        }
        if (last_tile && tid < T)
          wv[tid] = s0 + tid < Qv ? expf((float)(last - cum[s0 + tid])) : 0.f;
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int k = 0; k < N; ++k) {
          const float4 bv = *reinterpret_cast<const float4*>(bt + k * TS + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = ct[(ty + 16 * i) * CN + k];
            sc[i][0] = fmaf(a, bv.x, sc[i][0]);
            sc[i][1] = fmaf(a, bv.y, sc[i][1]);
            sc[i][2] = fmaf(a, bv.z, sc[i][2]);
            sc[i][3] = fmaf(a, bv.w, sc[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i, q = q0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + 4 * tx + j;
            // exp only on and below the diagonal, where cum_q - cum_s <= 0
            sc[i][j] = (s <= q && q < Qv) ? sc[i][j] * expf((float)(cum[q] - cum[s])) : 0.f;
          }
          *reinterpret_cast<float4*>(st + r * TS + 4 * tx) =
              make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
        }
        __syncthreads();

        for (int s = 0; s < T; ++s) {
          const float4 xv = *reinterpret_cast<const float4*>(xt + s * TS + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = st[(ty + 16 * i) * TS + s];
            acc[i][0] = fmaf(a, xv.x, acc[i][0]);
            acc[i][1] = fmaf(a, xv.y, acc[i][1]);
            acc[i][2] = fmaf(a, xv.z, acc[i][2]);
            acc[i][3] = fmaf(a, xv.w, acc[i][3]);
          }
        }
        if (last_tile) {
          // the state update's (B_s o w_s)^T x_s, rows n = ty + 16 i of the state
          for (int s = 0; s < T; ++s) {
            const float4 xv = *reinterpret_cast<const float4*>(xt + s * TS + 4 * tx);
            const float w = wv[s];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int n = ty + 16 * i;
              if (n < N) {
                const float a = bt[n * TS + s] * w;
                dh[i][0] = fmaf(a, xv.x, dh[i][0]);
                dh[i][1] = fmaf(a, xv.y, dh[i][1]);
                dh[i][2] = fmaf(a, xv.z, dh[i][2]);
                dh[i][3] = fmaf(a, xv.w, dh[i][3]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q < Qv) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * tx + j < PT) yp[(c0 + q) * ys.s + 4 * tx + j] = acc[i][j];
        }
      }
    }

    __syncthreads();                             // every query tile has read the old state
    const float decay = expf((float)last);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + 16 * i;
      if (n < N) {
        float* row = hs + n * TS + 4 * tx;
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] = fmaf(decay, row[j], dh[i][j]);
      }
    }
  }
}

}  // namespace

// Launcher: x (B,H,S,P) and y (B,H,S,P), each given by its pointer and its
// strides over (lane, head, position); dA (B,H,S) likewise; B and C (B,S,N) by
// their strides over (lane, position). The last dim of x, y, B and C is
// contiguous. Chunks of Q positions; 1 <= N <= 128. `strides` holds 13 values:
// x's three, dA's three, B's two, C's two, y's three. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int launch_ssd_scan_f32(const float* x, const float* dA, const float* Bm,
                                   const float* Cm, float* y, int Bn, int H, int S, int P,
                                   int N, int Q, const long long* st, void* stream) {
  if (Bn <= 0 || H <= 0 || S <= 0 || P <= 0 || N <= 0 || N > MAX_N || Q <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(N, Q) * sizeof(float);
  static size_t attribute = 48 * 1024;           // above 48 KB a kernel must ask
  if (smem > attribute) {
    cudaError_t e = cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attribute = smem;
  }
  const Str3 xs{st[0], st[1], st[2]}, das{st[3], st[4], st[5]}, ys{st[10], st[11], st[12]};
  const Str2 bs{st[6], st[7]}, cs{st[8], st[9]};
  dim3 grid((P + T - 1) / T, H, Bn);
  ssd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, dA, Bm, Cm, y, S, P, N, Q, xs,
                                                             das, bs, cs, ys);
  return (int)cudaGetLastError();
}
