// K1: fused residual, column sums of squares and preconditioner, written by
// hand for Hopper.
//
// Replaces the Pallas TPU kernel `_resid_precond_kernel` and its wrapper
// `fused_resid_precond` (pcx/operators/pallas_kernels.py:130, :200).  For a
// block of m columns x, hx of shape (m, 3, D) (complex64), Ritz values lam (m,)
// and the Hermitian 3x3 inverse-penalty symbol (real diag (3, D), complex
// sdiag = (s12, s13, s23) (3, D)) it computes in one pass
//   r_j    = lam_j x_j - (Hx)_j,
//   ss_j   = ||r_j||^2            (f32, as the TPU kernel),
//   w_j    = P r_j                (unmasked; the caller masks columns).
//
// What bounds it on an H100: memory bandwidth.  It reads two (m, 3, D) blocks
// and the symbol and writes one block, ~2 GB per call at m=16, N=120, with a
// few FLOPs per byte.  Design: one thread owns one (column, spatial index) at
// a time and all three components of it, because each row of the 3x3
// multiply needs r0, r1 and r2; loads and stores are 8-byte complex64,
// coalesced along D.  The TPU carried the column sums across its sequential
// grid (pallas_kernels.py:144-164); Hopper runs blocks in no fixed order, so
// each block writes one f32 partial per column and a second small kernel
// reduces the partials of each column in a fixed order.  No atomics: the
// result is deterministic.
//
// Lanes (the lockstep k-point batch): L problems of m columns each, x, hx
// (L, m, 3, D), lam (L, m) and one symbol per lane (L, 3, D), run as ONE
// launch of L*m columns on blockIdx.y; a column reads the symbol of its
// lane (column / m).  Each column's arithmetic and its partials are those
// of the one-lane launch, which is the same kernel at L = 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // spatial indices per thread, strided by kThreads

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
  if (wid == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // the block's sum, in thread 0
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {  // conj(a) b
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 scale_add(float d, float2 r, float2 u,
                                            float2 v) {
  return make_float2(d * r.x + u.x + v.x, d * r.y + u.y + v.y);
}

__global__ void __launch_bounds__(kThreads)
resid_precond_kernel(const float2* __restrict__ x, const float2* __restrict__ hx,
                     const float* __restrict__ lam,
                     const float* __restrict__ idiag,
                     const float2* __restrict__ isd, float2* __restrict__ w,
                     float* __restrict__ partial, long long D, int nblk,
                     int m) {
  const int col = blockIdx.y;  // lane * m + column of the lane
  const float l = lam[col];
  const long long off = (long long)col * 3 * D;
  const float2* xc = x + off;
  const float2* hc = hx + off;
  float2* wc = w + off;
  const long long soff = (long long)(col / m) * 3 * D;
  idiag += soff;
  isd += soff;

  float acc = 0.f;
  const long long start = (long long)blockIdx.x * kThreads * kItems + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = start + (long long)it * kThreads;
    if (i >= D) break;
    float2 r[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 xv = xc[c * D + i], hv = hc[c * D + i];
      r[c] = make_float2(l * xv.x - hv.x, l * xv.y - hv.y);
      acc += r[c].x * r[c].x + r[c].y * r[c].y;
    }
    const float d0 = idiag[i], d1 = idiag[D + i], d2 = idiag[2 * D + i];
    const float2 s0 = isd[i], s1 = isd[D + i], s2 = isd[2 * D + i];
    // y0 = d0 r0 + s12 r1 + s13 r2
    // y1 = conj(s12) r0 + d1 r1 + s23 r2
    // y2 = conj(s13) r0 + conj(s23) r1 + d2 r2   (pcx operators/rs.h_block_p)
    wc[i] = scale_add(d0, r[0], cmul(s0, r[1]), cmul(s1, r[2]));
    wc[D + i] = scale_add(d1, r[1], cmul_conj(s0, r[0]), cmul(s2, r[2]));
    wc[2 * D + i] = scale_add(d2, r[2], cmul_conj(s1, r[0]),
                              cmul_conj(s2, r[1]));
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[(long long)col * nblk + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int nblk) {
  const int col = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nblk; i += kThreads)
    acc += partial[(long long)col * nblk + i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[col] = acc;
}

}  // namespace

// Number of f32 partials per column the wrapper allocates for a given D.
extern "C" int pcx_resid_precond_blocks(long long D) {
  return (int)((D + (long long)kThreads * kItems - 1) /
               ((long long)kThreads * kItems));
}

// x, hx, w: complex64 (L, m, 3, D); lam: f32 (L, m); idiag: f32 (L, 3, D);
// isd: complex64 (L, 3, D); partial: f32 (L*m, pcx_resid_precond_blocks(D));
// sumsq: f32 (L, m).  All contiguous; one lane is L = 1 with the lane axis
// dropped.  Launches both kernels on `stream` and returns the first
// cudaError_t (0 on success).
extern "C" int pcx_resid_precond(const void* x, const void* hx,
                                 const void* lam, const void* idiag,
                                 const void* isd, void* w, void* partial,
                                 void* sumsq, int lanes, int m, long long D,
                                 void* stream) {
  const int nblk = pcx_resid_precond_blocks(D);
  if (lanes <= 0 || m <= 0 || (long long)lanes * m > 65535 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const int cols = lanes * m;
  cudaStream_t s = (cudaStream_t)stream;
  resid_precond_kernel<<<dim3(nblk, cols), kThreads, 0, s>>>(
      (const float2*)x, (const float2*)hx, (const float*)lam,
      (const float*)idiag, (const float2*)isd, (float2*)w, (float*)partial, D,
      nblk, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  column_sum_kernel<<<cols, kThreads, 0, s>>>((const float*)partial,
                                              (float*)sumsq, nblk);
  return (int)cudaGetLastError();
}
