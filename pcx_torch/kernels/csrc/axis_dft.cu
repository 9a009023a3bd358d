// K2: one axis pass of the matmul 3-D DFT, written by hand for Hopper.
//
// Replaces the Pallas TPU kernel `_axis_dft_kernel` and its wrapper
// `axis_dft_pairs` (pcx/operators/pallas_kernels.py:288, :323).  One pass maps
// x (B, A, J, K) -> y (B, J, K, C), y[b, j, k, c] = sum_a x[b, a, j, k] w[a, c]:
// it contracts the -3rd axis against the (A, C) twiddle and writes the
// transformed axis last, so three passes make a 3-D DFT and restore the axis
// order.  Data is complex64 (float2), every product and sum is IEEE f32 FMA
// (no TF32, no reduced-precision tensor-core path): a reduced-precision DFT
// raises the LOBPCG residual floor ~100x (pcx/operators/dft.py docstring).
//
// What bounds it on an H100: arithmetic.  A pass over a (48, 120, 120, 120)
// block reads and writes 2 x 663 MB but does 48 * 120^4 complex MACs
// (~80 GFLOP), so it sits far above the f32 CUDA-core ridge.  Design: each
// block owns one (b, j) row pair, a 32-wide tile of k and a 64-wide tile of
// c.  It stages 16-deep slices of x[b, a, j, k0:k0+32] (coalesced along k)
// and of w[a, c0:c0+64] (coalesced along c) in 12 KB of shared memory; each
// of its 256 threads keeps a 2 x 4 register tile of complex accumulators, so
// a shared-memory step feeds 32 FMAs from 6 shared loads.  Stores are
// coalesced along c, which is the contiguous axis of y.  The c-tiles are the
// fastest grid axis, so both c-tiles of one x tile run back to back and the
// second reads x from L2.  N = 100, 120, 150 are not multiples of the tiles:
// loads are zero-filled and stores masked at the ragged edges.

#include <cuda_runtime.h>

namespace {

constexpr int kTileK = 32;   // k positions per block
constexpr int kTileC = 64;   // output frequencies per block
constexpr int kStepA = 16;   // contraction depth per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
axis_dft_kernel(const float2* __restrict__ x, const float2* __restrict__ w,
                float2* __restrict__ y, int A, int J, int K, int C) {
  __shared__ float2 xs[kStepA][kTileK];
  __shared__ float2 ws[kStepA][kTileC];

  const int c0 = blockIdx.x * kTileC;
  const int k0 = blockIdx.y * kTileK;
  const int bj = blockIdx.z;  // b * J + j
  const int b = bj / J;
  const int j = bj - b * J;
  const int tid = threadIdx.x;
  const int tx = tid & 15;    // output columns c0 + tx + 16 q, q < 4
  const int ty = tid >> 4;    // output rows    k0 + ty + 16 i, i < 2

  const long long jk = (long long)J * K;
  const float2* xb = x + (long long)b * A * jk + (long long)j * K;

  float2 acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = make_float2(0.f, 0.f);

  for (int a0 = 0; a0 < A; a0 += kStepA) {
#pragma unroll
    for (int r = 0; r < kStepA * kTileK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int al = e / kTileK, kl = e % kTileK;
      const int a = a0 + al, k = k0 + kl;
      xs[al][kl] = (a < A && k < K) ? xb[(long long)a * jk + k]
                                    : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kStepA * kTileC / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int al = e / kTileC, cl = e % kTileC;
      const int a = a0 + al, c = c0 + cl;
      ws[al][cl] = (a < A && c < C) ? w[(long long)a * C + c]
                                    : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int al = 0; al < kStepA; ++al) {
      float2 xv[2], wv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) xv[i] = xs[al][ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q] = ws[al][tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q].x = fmaf(xv[i].x, wv[q].x,
                             fmaf(-xv[i].y, wv[q].y, acc[i][q].x));
          acc[i][q].y = fmaf(xv[i].x, wv[q].y,
                             fmaf(xv[i].y, wv[q].x, acc[i][q].y));
        }
    }
    __syncthreads();
  }

  float2* yb = y + (long long)bj * K * C;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c < C) yb[(long long)k * C + c] = acc[i][q];
    }
  }
}

}  // namespace

// x: complex64 (B, A, J, K) contiguous; w: complex64 (A, C) contiguous;
// y: complex64 (B, J, K, C) contiguous.  Launches on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int pcx_axis_dft(const void* x, const void* w, void* y, int B,
                            int A, int J, int K, int C, void* stream) {
  const long long bj = (long long)B * J;
  const int tiles_k = (K + kTileK - 1) / kTileK;
  const int tiles_c = (C + kTileC - 1) / kTileC;
  if (B <= 0 || A <= 0 || J <= 0 || K <= 0 || C <= 0 || bj > 65535 ||
      tiles_k > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(tiles_c, tiles_k, (unsigned)bj);
  axis_dft_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)w, (float2*)y, A, J, K, C);
  return (int)cudaGetLastError();
}
