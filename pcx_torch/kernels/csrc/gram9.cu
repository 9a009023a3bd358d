// K3: the fused Rayleigh-Ritz Gram, written by hand for Hopper.
//
// Replaces the Pallas TPU kernel `_gram9_kernel` and its callers
// `_gram9_call` / `fused_gram9_pairs` / `fused_gram9`
// (pcx/operators/pallas_kernels.py:27, :56, :75, :98).  For the six (m, D)
// complex64 blocks of the LOBPCG basis S = [X|W|P] and HS = [HX|HW|HP] it
// computes the 3m x 3m matrix
//   T[r, c] = sum_d conj(S[r, d]) HS[c, d]
// -- all nine (m x m) blocks, the lower triangle included -- with the TPU
// kernel's numerics: each D-chunk (default 2048) yields an f32 partial from
// IEEE f32 FMAs (no TF32), and the partials are summed in double.
//
// What bounds it on an H100: operations.  At m=16, D=3*120^3 it does
// 48*48*D*8 = 95.6 GFLOP on 3.98 GB of input, ~24 flop per byte: 1.43 ms at
// the card's 67 TFLOP/s of IEEE f32 against 1.19 ms for the bytes.  This
// first kernel is simple and right, not fast: it uses the CUDA cores' f32
// FMAs, not the tensor cores (wgmma, TMA, FP64 DMMA are later work).
//
// Design.  One block per (D-chunk, 48x48 output tile); at m <= 16 the
// whole T is one tile.  The block walks its chunk in sub-tiles of 32
// columns: 256 threads load a (48, 32) sub-tile of S and of HS into shared
// memory, 8-byte complex64 loads coalesced along D, rows padded to 33
// entries so that the 16 rows a warp reads at one column sit in distinct
// banks.  Each thread keeps a 3x3 register tile of complex f32 sums
// (rows ty + 16 i, columns tx + 16 j), 36 FMAs per staged column.  The D
// tail is masked to zero on load, not padded by a copy.  The TPU's grid ran
// its chunks in order; Hopper runs blocks in no fixed order, so each block
// writes its chunk's complex64 partial (3m, 3m) and a second kernel sums
// the partials of each entry in a fixed order in double.  No atomics: the
// result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 48;      // output tile edge (3m at m = 16)
constexpr int kSub = 32;       // staged D columns per step
constexpr int kThreads = 256;  // 16 x 16 threads, a 3x3 register tile each
constexpr int kReduceWarps = 16;

// The three (m, D) blocks of one stacked operand, [X|W|P] or [HX|HW|HP].
struct Stack {
  const float2* b0;
  const float2* b1;
  const float2* b2;
};

// Stage rows [row0, row0 + kTile) of a stacked operand, columns
// [d0, d0 + kSub), into tile; rows past 3m and columns past dend read zero.
__device__ __forceinline__ void stage(float2 (*tile)[kSub + 1],
                                      const Stack& st, int row0, int m,
                                      long long D, long long d0,
                                      long long dend) {
  constexpr int kRowsPerPass = kThreads / kSub;
  const int col = threadIdx.x % kSub;
  const long long d = d0 + col;
#pragma unroll
  for (int it = 0; it < kTile / kRowsPerPass; ++it) {
    const int r = threadIdx.x / kSub + it * kRowsPerPass;
    const int row = row0 + r;
    float2 v = make_float2(0.f, 0.f);
    if (row < 3 * m && d < dend) {
      const int blk = row / m;
      const float2* base = blk == 0 ? st.b0 : (blk == 1 ? st.b1 : st.b2);
      v = base[(long long)(row - blk * m) * D + d];
    }
    tile[r][col] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
gram9_partial_kernel(Stack s, Stack hs, float2* __restrict__ partial,
                     int m, long long D, int chunk) {
  __shared__ float2 as[kTile][kSub + 1];
  __shared__ float2 bs[kTile][kSub + 1];
  const int rows = 3 * m;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.z * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long dbeg = (long long)blockIdx.x * chunk;
  const long long dend = min(dbeg + chunk, D);

  float2 acc[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (long long d0 = dbeg; d0 < dend; d0 += kSub) {
    stage(as, s, r0, m, D, d0, dend);
    stage(bs, hs, c0, m, D, d0, dend);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kSub; ++k) {
      float2 a[3], b[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a[i] = as[ty + 16 * i][k];
        b[i] = bs[tx + 16 * i][k];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // conj(a) b = (ar br + ai bi) + i (ar bi - ai br)
          acc[i][j].x = fmaf(a[i].x, b[j].x, acc[i][j].x);
          acc[i][j].x = fmaf(a[i].y, b[j].y, acc[i][j].x);
          acc[i][j].y = fmaf(a[i].x, b[j].y, acc[i][j].y);
          acc[i][j].y = fmaf(-a[i].y, b[j].x, acc[i][j].y);
        }
    }
    __syncthreads();
  }

  float2* out = partial + (long long)blockIdx.x * rows * rows;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int r = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < rows && c < rows) out[r * rows + c] = acc[i][j];
    }
  }
}

// out[e] = sum over chunks of partial[chunk, e], in double.  A block owns
// 32 consecutive entries (one per lane); warp w sums chunks w, w + 16, ...
// in order, then lane-wise the 16 warp sums are added in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
gram9_reduce_kernel(const float2* __restrict__ partial,
                    double2* __restrict__ out, int nent, int nchunk) {
  __shared__ double2 sums[kReduceWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  double re = 0.0, im = 0.0;
  if (e < nent) {
    for (int c = w; c < nchunk; c += kReduceWarps) {
      const float2 v = partial[(long long)c * nent + e];
      re += (double)v.x;
      im += (double)v.y;
    }
  }
  sums[w][lane] = make_double2(re, im);
  __syncthreads();
  if (w == 0 && e < nent) {
    for (int i = 1; i < kReduceWarps; ++i) {
      re += sums[i][lane].x;
      im += sums[i][lane].y;
    }
    out[e] = make_double2(re, im);
  }
}

}  // namespace

// Number of D-chunks, i.e. complex64 (3m, 3m) partials the wrapper allocates.
extern "C" long long pcx_gram9_chunks(long long D, int chunk) {
  return (D + chunk - 1) / chunk;
}

// x, w, p, hx, hw, hp: complex64 (m, D), each contiguous; partial: complex64
// (pcx_gram9_chunks(D, chunk), 3m, 3m); out: complex128 (3m, 3m).  Launches
// both kernels on `stream` and returns the first cudaError_t (0 on success).
extern "C" int pcx_gram9(const void* x, const void* w, const void* p,
                         const void* hx, const void* hw, const void* hp,
                         void* partial, void* out, int m, long long D,
                         int chunk, void* stream) {
  const long long nchunk = pcx_gram9_chunks(D, chunk);
  const int tiles = (3 * m + kTile - 1) / kTile;
  if (m <= 0 || D <= 0 || chunk <= 0 || nchunk > 0x7fffffffLL ||
      tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const Stack s = {(const float2*)x, (const float2*)w, (const float2*)p};
  const Stack hs = {(const float2*)hx, (const float2*)hw, (const float2*)hp};
  cudaStream_t st = (cudaStream_t)stream;
  gram9_partial_kernel<<<dim3((unsigned)nchunk, tiles, tiles), kThreads, 0,
                         st>>>(s, hs, (float2*)partial, m, D, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nent = 9 * m * m;
  gram9_reduce_kernel<<<(nent + 31) / 32, 32 * kReduceWarps, 0, st>>>(
      (const float2*)partial, (double2*)out, nent, (int)nchunk);
  return (int)cudaGetLastError();
}
