// 3xTF32: f32-accurate products on Hopper's tensor cores, for K3 (gram9.cu).
//
// The TPU kernels ran their contractions at Precision.HIGHEST, a multi-pass
// bf16 emulation of f32 on the MXU.  The Hopper counterpart is the 3xTF32
// split: each f32 operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
// (as cvt.rna: round to nearest, ties away from zero, to 10 mantissa bits),
// and a*b ~ lo*hi' + hi*lo' + hi*hi', three m16n8k8 TF32 MMAs accumulated
// in f32, the small products first (as CUTLASS's fast-f32 warp MMA,
// cutlass/gemm/warp/mma_tensor_op_fast_f32.h).  Only lo*lo' (~2^-22
// relative) is dropped.  A single-pass TF32 product (~1e-3 relative) is not
// offered.
//
// Operands are complex64 (float2) in shared memory.  A fragment load reads
// float2 elements, de-interleaves them into real and imaginary planes and
// splits each into hi and lo in registers.  A complex product is four real
// products (re += ar*br - ai*bi, im += ar*bi + ai*br), the TPU's stacked
// twiddle [[wr, wi], [-wi, wr]], never the 3-multiply Gauss form.
//
// Fragment layouts are PTX's for mma.m16n8k8 with .tf32 operands: lane =
// 4 * g + t; A (16 x 8): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B (8 x 8): (t, g), (t + 4, g); C (16 x 8): (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tf32x3 {

// One real operand fragment, split: hi and lo planes in TF32.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// tf32(x) in f32 layout (low 13 bits zero): the result of cvt.rna.tf32.f32,
// computed with two integer ops on the bits -- add half a TF32 ulp to the
// sign-magnitude bits, clear the low 13 -- which rounds to nearest with ties
// away from zero exactly as cvt.rna does for finite x.  The cvt instruction
// issues on a slower pipe than integer adds and logic, and with two splits
// per operand element it held both kernels back on the H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // x - hi is exact in f32
}

// d += a * b, one m16n8k8 TF32 MMA with f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at f32 accuracy: the three-MMA step, small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// -a, exactly: the sign bits of both planes flipped.
__device__ __forceinline__ FragA neg(const FragA& a) {
  FragA r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.hi[i] = a.hi[i] ^ 0x80000000u;
    r.lo[i] = a.lo[i] ^ 0x80000000u;
  }
  return r;
}

// Complex (re, im) += conj(A) * B; A = ar + i ai, B = br + i bi, each
// product three MMAs: re += ar br + ai bi,  im += ar bi - ai br.
// The tensor core's f32 accumulation does not round to nearest (its adds
// truncate), so over a long chain of MMAs into one accumulator the errors
// add up with a bias.  Each k8 step's product is therefore formed in fresh
// registers, six MMAs deep, and added to the running sums (re, im) with IEEE
// f32 adds, which round to nearest.  nai = neg(ai): the caller negates an
// A fragment once for all the B fragments it meets.
__device__ __forceinline__ void cmma(float (&re)[4], float (&im)[4],
                                     const FragA& ar, const FragA& ai,
                                     const FragA& nai, const FragB& br,
                                     const FragB& bi) {
  float tr[4] = {0.f, 0.f, 0.f, 0.f}, ti[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(tr, ar, br);
  mma3(tr, ai, bi);
  mma3(ti, ar, bi);
  mma3(ti, nai, br);
#pragma unroll
  for (int i = 0; i < 4; ++i) re[i] += tr[i], im[i] += ti[i];
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// The A fragment of a 16 x 8 complex tile whose element (m, k) lies at
// src[m * sm + k * sk], split into its real and imaginary planes.
__device__ __forceinline__ void load_a(const float2* src, int sm, int sk,
                                       FragA& re, FragA& im) {
  const int g = lane_g(), t = lane_t();
  const float2 v[4] = {src[g * sm + t * sk], src[(g + 8) * sm + t * sk],
                       src[g * sm + (t + 4) * sk],
                       src[(g + 8) * sm + (t + 4) * sk]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split(v[i].x, re.hi[i], re.lo[i]);
    split(v[i].y, im.hi[i], im.lo[i]);
  }
}

// The B fragment of an 8 x 8 complex tile whose element (k, n) lies at
// src[k * sk + n * sn], split into its real and imaginary planes.
__device__ __forceinline__ void load_b(const float2* src, int sk, int sn,
                                       FragB& re, FragB& im) {
  const int g = lane_g(), t = lane_t();
  const float2 v[2] = {src[t * sk + g * sn], src[(t + 4) * sk + g * sn]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    split(v[i].x, re.hi[i], re.lo[i]);
    split(v[i].y, im.hi[i], im.lo[i]);
  }
}

// cp.async staging: `bytes` (16 or 8) from global to shared memory, or
// zeros where !valid (src-size 0: nothing is read).  16-byte copies bypass
// L1 (.cg); 8-byte ones must go through it (.ca).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  static_assert(kBytes == 16 || kBytes == 8, "cp.async of 16 or 8 bytes");
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace tf32x3
