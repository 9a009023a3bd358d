// K3: the fused Rayleigh-Ritz Gram, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel `_gram9_kernel` and its callers
// `_gram9_call` / `fused_gram9_pairs` / `fused_gram9`
// (pcx/operators/pallas_kernels.py:27, :56, :75, :98).  For the six (m, D)
// complex64 blocks of the LOBPCG basis S = [X|W|P] and HS = [HX|HW|HP] it
// computes the 3m x 3m matrix
//   T[r, c] = sum_d conj(S[r, d]) HS[c, d]
// -- all nine (m x m) blocks, the lower triangle included -- with the TPU
// kernel's numerics: each D-chunk (default 2048) yields an f32 partial, and
// the partials are summed in double in a fixed order.  The TPU ran its
// products at Precision.HIGHEST; here they are the 3xTF32 split of
// tf32x3.cuh (f32 accuracy, no single-pass TF32).
//
// What bounds it on an H100, m=16, D=3*120^3 (95.6 GFLOP of conjugate
// products counted as 8 flop each, 3.98 GB of input):
//   * IEEE f32 on the CUDA cores (the earlier design): 1.43 ms at 66.9 TFLOP/s,
//     operations;
//   * 3xTF32 mma.sync (this kernel): 3 x 95.6 GFLOP at 495 TFLOP/s =
//     0.58 ms, so the bytes bound it: 3.98 GB at 3.35 TB/s = 1.19 ms.
//
// Design.  Both operands are D-contiguous rows, so a (48, 32) slice of S
// and of HS stages as K-major tiles with 16-byte cp.async in a 4-stage ring
// of dynamic shared memory (rows padded to 36 complex, so fragment loads
// hit distinct banks); three stages' copies are in flight while the tensor
// cores work on the fourth.  The stacked operands are never built: each
// thread's copy rows are resolved to their block's pointer once.  6 warps:
// 3 along rows (one m16 tile and all six n8 tiles each, so an A fragment
// is split once for six MMA tiles) x 2 groups that take the first and the
// second half of each stage's depth; at a chunk's end group 1 hands its
// sums to group 0 through shared memory.  A conjugate product is real
// products T_re = Sr HSr^T + Si HSi^T, T_im = Sr HSi^T - Si HSr^T, 12 MMAs
// per complex m16n8k8 step.  A block walks the chunks blockIdx.x,
// blockIdx.x + gridDim.x, ... in turn with the ring running across chunk
// boundaries; at each chunk's end it writes the chunk's complex64 partial
// (3m, 3m) and clears its sums, so the grid is sized to the resident
// blocks and every SM keeps bytes in flight.  A partial depends only on its
// chunk, so the result does not depend on the grid.  The D tail and the
// chunk ends are masked on load (zero-filled), rows past 3m too.  A second
// kernel sums the partials of each entry in a fixed order in double.  No
// atomics: the result is deterministic.
//
// Lanes (the lockstep k-point batch): six (L, m, D) blocks give L Grams
// (L, 3m, 3m) in ONE launch of each kernel.  The lane rides on blockIdx.z
// beside the column tile (z = lane * tiles + tile); a block offsets its six
// row pointers by lane * m * D and writes its partials to the lane's
// (nchunk, 3m, 3m) slab, and the reduction sums each lane's entries over
// that lane's chunks.  The grid is sized to the resident blocks over all
// lanes.  A partial still depends only on its lane and chunk, so each
// lane's Gram is the one-lane launch's, which is the same kernels at L = 1.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kTile = 48;        // output tile edge (3m at m = 16)
constexpr int kWarpsR = 3;       // warps along rows, one m16 tile each
constexpr int kGroups = 2;       // warp groups, each half of a stage's depth
constexpr int kNT = kTile / 8;   // n8 tiles per warp: all 48 columns
constexpr int kThreads = 32 * kWarpsR * kGroups;
constexpr int kStepD = 32;               // D columns per stage
constexpr int kStages = 4;
constexpr int kSD = kStepD + 4;          // stage row stride (complex)
constexpr int kStage = 2 * kTile * kSD;  // the S tile, then the HS tile
constexpr int kSmemBytes = 8 * kStages * kStage;
constexpr int kReduceWarps = 16;

// The three (m, D) blocks of one stacked operand, [X|W|P] or [HX|HW|HP].
struct Stack {
  const float2* b0;
  const float2* b1;
  const float2* b2;
};

__device__ __forceinline__ const float2* row_ptr(const Stack& st, int row,
                                                 int m, long long D) {
  const int blk = row / m;
  const float2* base = blk == 0 ? st.b0 : (blk == 1 ? st.b1 : st.b2);
  return base + (long long)(row - blk * m) * D;
}

// kVec: 16-byte copies (D and chunk even, blocks 16-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gram9_partial_kernel(Stack s, Stack hs, float2* __restrict__ partial,
                     int m, long long D, int chunk, long long nchunk) {
  constexpr int kE = kVec ? 2 : 1;                 // complex per copy
  constexpr int kPerRow = kStepD / kE;             // copies per staged row
  constexpr int kRowStep = kThreads / kPerRow;     // rows between copies
  constexpr int kCopies = 2 * kTile / kRowStep;    // copies per thread
  static_assert(kThreads % kPerRow == 0 && 2 * kTile % kRowStep == 0,
                "whole copies per thread");
  extern __shared__ __align__(16) float2 smem[];

  const int rows = 3 * m;
  const int tiles = (rows + kTile - 1) / kTile;
  const int lane = blockIdx.z / tiles;
  const long long loff = (long long)lane * m * D;
  partial += (long long)lane * nchunk * rows * rows;
  const int r0 = blockIdx.y * kTile, c0 = (blockIdx.z % tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int wr = warp % kWarpsR, kg = warp / kWarpsR;
  const bool r_on = r0 + 16 * wr < rows;

  // Each thread copies the same (row, column) slots of every stage: staged
  // rows 0..47 are S rows r0.., 48..95 HS rows c0..; null past 3m.
  const int col = (threadIdx.x % kPerRow) * kE;
  const float2* src[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int sr = threadIdx.x / kPerRow + i * kRowStep;
    const int gr = (sr < kTile ? r0 : c0) + sr % kTile;
    src[i] = gr < rows ? row_ptr(sr < kTile ? s : hs, gr, m, D) + loff + col
                       : nullptr;
  }
  auto load = [&](int slot, long long d0, long long dend) {
    float2* dst = smem + slot * kStage + col;
    const bool in_d = d0 + col < dend;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int sr = threadIdx.x / kPerRow + i * kRowStep;
      const bool ok = in_d && src[i] != nullptr;
      tf32x3::cp_async<8 * kE>(dst + sr * kSD, ok ? src[i] + d0 : s.b0, ok);
    }
  };
  auto chunk_end = [&](long long ch) {
    return min((ch + 1) * (long long)chunk, D);
  };

  float acc_re[kNT][4], acc_im[kNT][4];
#pragma unroll
  for (int q = 0; q < kNT; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_re[q][i] = acc_im[q][i] = 0.f;

  // Load cursor (lch, ld0) runs kStages - 1 stages ahead of the compute
  // cursor (cch, cd0); both step through this block's chunks in turn.
  long long lch = blockIdx.x, ld0 = lch * chunk;
  auto advance = [&](long long& ch, long long& d0) {
    d0 += kStepD;
    if (d0 >= chunk_end(ch)) {
      ch += gridDim.x;
      d0 = ch * chunk;
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (lch < nchunk) {
      load(st, ld0, chunk_end(lch));
      advance(lch, ld0);
    }
    tf32x3::cp_async_commit();
  }

  long long cch = blockIdx.x, cd0 = cch * chunk;
  int slot = 0;
  while (cch < nchunk) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (lch < nchunk) {
      load((slot + kStages - 1) % kStages, ld0, chunk_end(lch));
      advance(lch, ld0);
    }
    tf32x3::cp_async_commit();
    if (r_on) {
      const float2* ss = smem + slot * kStage;
      const float2* hss = ss + kTile * kSD;
#pragma unroll
      for (int kq = 0; kq < kStepD / 8 / kGroups; ++kq) {
        const int kk = kg * (kStepD / 8 / kGroups) + kq;
        // A: element (r, d) at ss[r * kSD + d]; B: (d, c) at hss[c * kSD + d]
        tf32x3::FragA ar, ai;
        tf32x3::load_a(ss + 16 * wr * kSD + 8 * kk, kSD, 1, ar, ai);
        const tf32x3::FragA nai = tf32x3::neg(ai);
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          if (c0 + 8 * q >= rows) break;
          tf32x3::FragB br, bi;
          tf32x3::load_b(hss + 8 * q * kSD + 8 * kk, 1, kSD, br, bi);
          tf32x3::cmma(acc_re[q], acc_im[q], ar, ai, nai, br, bi);
        }
      }
    }
    const long long ch = cch;
    advance(cch, cd0);
    if (cch != ch) {
      // The chunk is done.  Group 1 hands its sums to group 0 through the
      // ring slot just consumed (refilled only after the next barrier at
      // the loop's top), group 0 adds them and writes the chunk's partial.
      __syncthreads();
      float4* red = reinterpret_cast<float4*>(smem + slot * kStage);
      const int lane = threadIdx.x & 31;
      if (kg == 1 && r_on) {
#pragma unroll
        for (int q = 0; q < kNT; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            red[((wr * kNT + q) * 2 + h) * 32 + lane] =
                make_float4(acc_re[q][2 * h], acc_im[q][2 * h],
                            acc_re[q][2 * h + 1], acc_im[q][2 * h + 1]);
            acc_re[q][2 * h] = acc_im[q][2 * h] = 0.f;
            acc_re[q][2 * h + 1] = acc_im[q][2 * h + 1] = 0.f;
          }
      }
      __syncthreads();
      if (kg == 0 && r_on) {
        float2* out = partial + ch * rows * rows;
        const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          const int c = c0 + 8 * q + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 o = red[((wr * kNT + q) * 2 + h) * 32 + lane];
            const int r = r0 + 16 * wr + g + 8 * h;
            if (r < rows && c < rows)
              out[r * rows + c] = make_float2(acc_re[q][2 * h] + o.x,
                                              acc_im[q][2 * h] + o.y);
            if (r < rows && c + 1 < rows)
              out[r * rows + c + 1] = make_float2(
                  acc_re[q][2 * h + 1] + o.z, acc_im[q][2 * h + 1] + o.w);
            acc_re[q][2 * h] = acc_im[q][2 * h] = 0.f;
            acc_re[q][2 * h + 1] = acc_im[q][2 * h + 1] = 0.f;
          }
        }
      }
    }
    slot = (slot + 1) % kStages;
  }
  tf32x3::cp_async_wait<0>();
}

// out[g, e] = sum over chunks of partial[g, chunk, e], in double, for the
// Gram g (blockIdx.y) of each problem of the batch.  A block owns 32
// consecutive entries (one per lane of the warp); warp w sums chunks w,
// w + 16, ... in order, then lane-wise the 16 warp sums are added in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
gram9_reduce_kernel(const float2* __restrict__ partial,
                    double2* __restrict__ out, int nent, int nchunk) {
  __shared__ double2 sums[kReduceWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  partial += (long long)blockIdx.y * nchunk * nent;
  out += (long long)blockIdx.y * nent;
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

// The partial kernel on as many blocks as fit on the card at once (each
// walks its chunks in turn), then the reduction.
template <bool kVec>
int launch(const Stack& s, const Stack& hs, float2* partial, double2* out,
           int lanes, int m, long long D, int chunk, long long nchunk,
           int tiles, cudaStream_t st) {
  auto kernel = gram9_partial_kernel<kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long fit =
      (long long)sms * per_sm / ((long long)tiles * tiles * lanes);
  const long long nblk = fit < 1 ? 1 : (fit < nchunk ? fit : nchunk);
  kernel<<<dim3((unsigned)nblk, tiles, tiles * lanes), kThreads, kSmemBytes,
           st>>>(s, hs, partial, m, D, chunk, nchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nent = 9 * m * m;
  gram9_reduce_kernel<<<dim3((nent + 31) / 32, lanes), 32 * kReduceWarps, 0,
                        st>>>(partial, out, nent, (int)nchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of D-chunks, i.e. complex64 (3m, 3m) partials the wrapper allocates.
extern "C" long long pcx_gram9_chunks(long long D, int chunk) {
  return (D + chunk - 1) / chunk;
}

// x, w, p, hx, hw, hp: complex64 (L, m, D), each contiguous; partial:
// complex64 (L, pcx_gram9_chunks(D, chunk), 3m, 3m); out: complex128
// (L, 3m, 3m); one lane is L = 1 with the lane axis dropped.  Launches both
// kernels on `stream` and returns the first cudaError_t (0 on success).
extern "C" int pcx_gram9(const void* x, const void* w, const void* p,
                         const void* hx, const void* hw, const void* hp,
                         void* partial, void* out, int lanes, int m,
                         long long D, int chunk, void* stream) {
  const long long nchunk = pcx_gram9_chunks(D, chunk);
  const int tiles = (3 * m + kTile - 1) / kTile;
  if (lanes <= 0 || m <= 0 || D <= 0 || chunk <= 0 ||
      nchunk > 0x7fffffffLL || (long long)tiles * lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const Stack s = {(const float2*)x, (const float2*)w, (const float2*)p};
  const Stack hs = {(const float2*)hx, (const float2*)hw, (const float2*)hp};
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(x) |
      reinterpret_cast<unsigned long long>(w) |
      reinterpret_cast<unsigned long long>(p) |
      reinterpret_cast<unsigned long long>(hx) |
      reinterpret_cast<unsigned long long>(hw) |
      reinterpret_cast<unsigned long long>(hp);
  // a lane starts m * D complex past the last: 16-byte aligned when D is even
  const bool vec = D % 2 == 0 && chunk % 2 == 0 && (addr & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<true>(s, hs, (float2*)partial, (double2*)out, lanes, m,
                            D, chunk, nchunk, tiles, st)
             : launch<false>(s, hs, (float2*)partial, (double2*)out, lanes, m,
                             D, chunk, nchunk, tiles, st);
}
