// K2: one axis pass of the matmul 3-D DFT, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel `_axis_dft_kernel` and its wrapper
// `axis_dft_pairs` (pcx/operators/pallas_kernels.py:288, :323).  One pass maps
// x (B, A, J, K) -> y (B, J, K, C), y[b, j, k, c] = sum_a x[b, a, j, k] w[a, c]:
// it contracts the -3rd axis against the (A, C) twiddle and writes the
// transformed axis last, so three passes make a 3-D DFT and restore the axis
// order.  Data is complex64 (float2).
//
// Numerics: the TPU kernel ran its real matmul at Precision.HIGHEST; here
// every product is the 3xTF32 split of tf32x3.cuh (f32 accuracy; single-pass
// TF32 would raise the LOBPCG residual floor ~100x, pcx/operators/dft.py).
//
// What bounds it on an H100, B=48, N=120 (79.6 GFLOP of complex products
// counted as 8 flop each, 1.33 GB read and written once):
//   * IEEE f32 on the CUDA cores (the earlier design): 1.19 ms at 66.9 TFLOP/s;
//   * 3xTF32 mma.sync (this kernel): 3 x 79.6 GFLOP at the dense TF32 rate
//     of 495 TFLOP/s = 0.48 ms, operations; its bytes alone take 0.40 ms.
//
// Design.  Per (b, j) the pass is a complex GEMM Y (K x C) = X^T (K x A) W
// (A x C) whose A operand is x[b, :, j, :], contiguous along k, stride J*K
// along a.  A block owns one (b, j), a 64-wide tile of k and all of C (up to
// 160 columns; wider C takes more column tiles), so x is read from device
// memory once.  It stages 16-deep slices of x (16 x 64) and of w (16 x C)
// with 16-byte cp.async in a 3-stage ring in dynamic shared memory (rows
// padded by 4 complex so fragment loads hit distinct banks); the next
// stage's copies are in flight while the tensor cores work on this one.
// mma.sync takes every operand from registers, so the strided contraction
// axis and the hi/lo split cost no extra pass (TF32 wgmma would want both
// shared operands K-major).  8 warps: 4 along k (one m16 tile each) x 2
// along c (8 or 10 n8 tiles each, interleaved), 12 MMAs per complex m16n8k8
// product.  The output tile is staged through shared memory (rows padded
// by 8 complex) and stored with 16-byte writes along c, which is contiguous
// in y.  Ragged edges: loads past A, K or C are zero-filled by cp.async,
// whole m16 / n8 tiles and k8 steps past them are skipped, stores are masked.
//
// Padding share (MMAs issued / MMAs of the useful k x c x a volume, at the
// m16 / n8 / k8 granularity):
//   N = 100: 112/100 * 104/100 * 104/100 = 1.21
//   N = 120: 128/120 * 120/120 * 120/120 = 1.07
//   N = 150: 160/150 * 152/150 * 152/150 = 1.10

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsK = 4;            // warps along k, one m16 tile each
constexpr int kWarpsC = 2;            // warps along c
constexpr int kTileK = 16 * kWarpsK;  // 64 k positions per block
constexpr int kStepA = 16;            // contraction depth per stage
constexpr int kStages = 3;
constexpr int kPadRing = 4;           // row pads (complex) of the ring ...
constexpr int kPadOut = 8;            // ... and of the output tile

template <int NT>
struct Tiles {
  static constexpr int kTileC = 8 * NT * kWarpsC;   // 128 or 160 columns
  static constexpr int kSX = kTileK + kPadRing;     // x stage row stride
  static constexpr int kSW = kTileC + kPadRing;     // w stage row stride
  static constexpr int kSY = kTileC + kPadOut;      // output row stride
  static constexpr int kStage = kStepA * (kSX + kSW);
  static constexpr int kRing = kStages * kStage;
  static constexpr int kOut = kTileK * kSY;
  static constexpr int kSmemBytes =
      8 * (kRing > kOut ? kRing : kOut);
};

// Stage x[b, a0:a0+16, j, k0:k0+64] and w[a0:a0+16, c0:c0+kTileC] into one
// ring slot; zeros past A, K and C.  kVec: 16-byte copies (K and C even).
template <int NT, bool kVec>
__device__ __forceinline__ void load_stage(float2* xs, float2* ws,
                                           const float2* xb, const float2* w,
                                           int a0, int k0, int c0, int A,
                                           long long jk, int K, int C) {
  using T = Tiles<NT>;
  constexpr int kE = kVec ? 2 : 1;  // complex per copy
  constexpr int kXr = kTileK / kE, kWr = T::kTileC / kE;
  static_assert(kStepA * kXr % kThreads == 0 &&
                kStepA * kWr % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int r = 0; r < kStepA * kXr / kThreads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int al = e / kXr, kl = (e % kXr) * kE;
    const int a = a0 + al, k = k0 + kl;
    const bool ok = a < A && k < K;
    tf32x3::cp_async<8 * kE>(xs + al * T::kSX + kl,
                             ok ? xb + a * jk + k : xb, ok);
  }
#pragma unroll
  for (int r = 0; r < kStepA * kWr / kThreads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    const int al = e / kWr, cl = (e % kWr) * kE;
    const int a = a0 + al, c = c0 + cl;
    const bool ok = a < A && c < C;
    tf32x3::cp_async<8 * kE>(ws + al * T::kSW + cl,
                             ok ? w + (long long)a * C + c : w, ok);
  }
}

template <int NT, bool kVec>
__global__ void __launch_bounds__(kThreads, NT <= 8 ? 2 : 1)
axis_dft_kernel(const float2* __restrict__ x, const float2* __restrict__ w,
                float2* __restrict__ y, int A, int J, int K, int C) {
  using T = Tiles<NT>;
  extern __shared__ __align__(16) float2 smem[];

  const int c0 = blockIdx.x * T::kTileC;
  const int k0 = blockIdx.y * kTileK;
  const int bj = blockIdx.z;  // b * J + j
  const int b = bj / J;
  const int j = bj - b * J;
  const int warp = threadIdx.x >> 5;
  const int wk = warp % kWarpsK, wc = warp / kWarpsK;
  const long long jk = (long long)J * K;
  const float2* xb = x + (long long)b * A * jk + (long long)j * K;

  // This warp's m16 tile (k rows 16 wk ..) and n8 tiles (columns
  // 8 (wc + 2 q) ..); tiles wholly past K or C are skipped.
  const bool m_on = k0 + 16 * wk < K;
  float acc_re[NT][4], acc_im[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_re[q][i] = acc_im[q][i] = 0.f;

  const int steps = (A + kStepA - 1) / kStepA;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<NT, kVec>(smem + s * T::kStage,
                           smem + s * T::kStage + kStepA * T::kSX, xb, w,
                           s * kStepA, k0, c0, A, jk, K, C);
    tf32x3::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < steps) {
      float2* slot = smem + (nxt % kStages) * T::kStage;
      load_stage<NT, kVec>(slot, slot + kStepA * T::kSX, xb, w,
                           nxt * kStepA, k0, c0, A, jk, K, C);
    }
    tf32x3::cp_async_commit();
    if (!m_on) continue;
    const float2* xs = smem + (s % kStages) * T::kStage;
    const float2* ws = xs + kStepA * T::kSX;
#pragma unroll
    for (int kk = 0; kk < kStepA / 8; ++kk) {
      if (s * kStepA + 8 * kk >= A) break;
      // A operand: element (k, a) of the tile at xs[a * kSX + k]
      tf32x3::FragA ar, ai;
      tf32x3::load_a(xs + 8 * kk * T::kSX + 16 * wk, 1, T::kSX, ar, ai);
      const tf32x3::FragA nai = tf32x3::neg(ai);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int nt = wc + kWarpsC * q;
        if (c0 + 8 * nt >= C) break;
        // B operand: element (a, c) at ws[a * kSW + c]
        tf32x3::FragB br, bi;
        tf32x3::load_b(ws + 8 * kk * T::kSW + 8 * nt, T::kSW, 1, br, bi);
        tf32x3::cmma<false>(acc_re[q], acc_im[q], ar, ai, nai, br, bi);
      }
    }
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  // Output tile through shared memory: ys[k_local * kSY + c_local].
  float2* ys = smem;
  if (m_on) {
    const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int nt = wc + kWarpsC * q;
      if (c0 + 8 * nt >= C) break;
      float2* p = ys + (16 * wk + g) * T::kSY + 8 * nt + 2 * t;
      *reinterpret_cast<float4*>(p) =
          make_float4(acc_re[q][0], acc_im[q][0], acc_re[q][1], acc_im[q][1]);
      *reinterpret_cast<float4*>(p + 8 * T::kSY) =
          make_float4(acc_re[q][2], acc_im[q][2], acc_re[q][3], acc_im[q][3]);
    }
  }
  __syncthreads();

  const int rows = min(kTileK, K - k0), cols = min(T::kTileC, C - c0);
  float2* yb = y + ((long long)bj * K + k0) * C + c0;
  if (kVec) {
    constexpr int kPairs = T::kTileC / 2;
    for (int e = threadIdx.x; e < rows * kPairs; e += kThreads) {
      const int r = e / kPairs, cl = 2 * (e % kPairs);
      if (cl < cols)
        *reinterpret_cast<float4*>(yb + (long long)r * C + cl) =
            *reinterpret_cast<const float4*>(ys + r * T::kSY + cl);
    }
  } else {
    for (int e = threadIdx.x; e < rows * T::kTileC; e += kThreads) {
      const int r = e / T::kTileC, cl = e % T::kTileC;
      if (cl < cols) yb[(long long)r * C + cl] = ys[r * T::kSY + cl];
    }
  }
}

template <int NT, bool kVec>
int launch(const float2* x, const float2* w, float2* y, int B, int A, int J,
           int K, int C, cudaStream_t stream) {
  using T = Tiles<NT>;
  auto kernel = axis_dft_kernel<NT, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + T::kTileC - 1) / T::kTileC,
                  (K + kTileK - 1) / kTileK, (unsigned)(B * J));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(x, w, y, A, J, K, C);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_nt(const float2* x, const float2* w, float2* y, int B, int A,
              int J, int K, int C, cudaStream_t stream) {
  // 16-byte copies need every row start of x, w and y 16-byte aligned.
  const bool vec = K % 2 == 0 && C % 2 == 0 &&
                   ((reinterpret_cast<unsigned long long>(x) |
                     reinterpret_cast<unsigned long long>(w) |
                     reinterpret_cast<unsigned long long>(y)) & 15) == 0;
  return vec ? launch<NT, true>(x, w, y, B, A, J, K, C, stream)
             : launch<NT, false>(x, w, y, B, A, J, K, C, stream);
}

}  // namespace

// x: complex64 (B, A, J, K) contiguous; w: complex64 (A, C) contiguous;
// y: complex64 (B, J, K, C) contiguous.  Launches on `stream`; returns the
// cudaError_t of the set-up and the launch (0 on success).
extern "C" int pcx_axis_dft(const void* x, const void* w, void* y, int B,
                            int A, int J, int K, int C, void* stream) {
  const long long bj = (long long)B * J;
  if (B <= 0 || A <= 0 || J <= 0 || K <= 0 || C <= 0 || bj > 65535 ||
      (K + kTileK - 1) / kTileK > 65535)
    return (int)cudaErrorInvalidValue;
  const float2 *xp = (const float2*)x, *wp = (const float2*)w;
  float2* yp = (float2*)y;
  cudaStream_t st = (cudaStream_t)stream;
  // 128 columns (N = 100, 120) take 8 n8 tiles a warp; wider C takes 10
  // (N = 150 in one tile of 160).
  return C <= Tiles<8>::kTileC
             ? launch_nt<8>(xp, wp, yp, B, A, J, K, C, st)
             : launch_nt<10>(xp, wp, yp, B, A, J, K, C, st);
}
