// K7: the cross-DoF inverse dielectric, written by hand for Hopper.
//
// Replaces no Pallas kernel: the JAX package writes this stencil
// (`make_crossdof_apply`, pcx/operators/dielectric.py) as jnp.roll
// arithmetic that XLA fuses.  On the card the port ran it as eager PyTorch:
// per nonzero pair two T chains of 2k-tap averagings (a multiply, a
// torch.roll and an add per tap) on each side, the mask products and the
// accumulations, 33 kernels and ~82 component-sized reads and writes at
// k = 1 with one pair, where the function needs 6 (x's three components in,
// y's three out).  K7 computes the whole apply in one launch:
//   y_c = x_c diag_c
//       + sum over nonzero pairs (r, c) of the row block
//           (0.5 e) (m_r T x_c + T (m_c x_c))          added to y_r,
//         and of its conjugate transpose
//           conj(0.5 e) (m_c T^T x_r + T^T (m_r x_r))  added to y_c,
// with T the separable 2k-tap averaging of the pair (pair 12: along k, then
// transposed along j; 13: k, then i transposed; 23: j, then i transposed)
// and m the edge masks.
//
// The same bits as the eager composition: every product and sum is rounded
// to f32 where PyTorch rounds it and in its order, by explicit
// round-to-nearest intrinsics, which nvcc does not contract.  Each 1-D
// averaging starts from w_0 term_0 and adds w_t term_t in tap order, the
// first axis's value rounded at every point before the second axis reads
// it; then t m_row, + T(m_col x_col), and y + (0.5 e) t with PyTorch's
// complex product (`cmul`); pairs in the order 12, 13, 23, row before
// column.  A real factor (a tap, a mask, the diagonal) times a complex
// value rounds each part once, as PyTorch's product of the promoted (r, 0)
// does.
//
// What bounds it on an H100: the bytes.  At m=16, N=120 with one pair it
// reads x (16 columns of 3 components) and writes y, 48 bytes a grid point
// and column, plus the diagonal and two masks once, 1.36 GB, 0.41 ms at
// 3.35 TB/s; its ~60 FLOP a point and column at k = 1 lie far below the
// card's balance point.  Design: one thread a grid point, consecutive
// threads on consecutive points along k, so every read of a warp is one
// contiguous run; a thread walks the columns of its group and computes its
// point's three outputs of each, reading the 2k x 2k neighbourhoods the
// pairs' stencils need straight from device memory through the L1 cache.
// Neighbouring threads and warps read the same neighbourhoods, so a value
// comes from device memory once and from L1 or L2 for its other taps; the
// masks and the diagonal, the same for every column, stay in L1 while a
// block walks its columns, so they are read from device memory once per
// launch and not once per column.  Periodic wrap is folded into per-thread
// offsets computed once.  No reduction, so the result does not depend on
// the grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 3;

struct Problem {
  const float2* x;    // (cols, 3, N, N, N)
  const float* diag;  // (3, N, N, N)
  const float* masks; // (3, N, N, N)
  float2* y;          // like x
  long long V;        // N^3
  int n, cols;
  int group;          // columns per block
  int point_blocks;   // blocks of kThreads points covering N^3
  int active;         // bit p: pair p (12, 13, 23) nonzero
  float w[2 * kMaxK];
  float2 alpha[3];    // 0.5 e of each pair
};

// The complex product a * b as PyTorch's complex64 multiply rounds it on
// the card: (a.x b.x - a.y b.y, a.x b.y + a.y b.x) with the first product
// of each part fused.  `y.add_(t, alpha=a)` computes y + a * t.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 rmul(float r, float2 b) {
  return make_float2(__fmul_rn(r, b.x), __fmul_rn(r, b.y));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

// o[d + K]: the offset of the point d places along an axis, wrapped, from a
// point at coordinate c of an axis of stride s.
template <int K>
__device__ __forceinline__ void offsets(int c, int n, int s,
                                        int (&o)[2 * K + 1]) {
#pragma unroll
  for (int d = -K; d <= K; ++d) {
    int v = c + d;
    while (v < 0) v += n;
    while (v >= n) v -= n;
    o[d + K] = (v - c) * s;
  }
}

// One pair's T (kTr false: axis 1 forward, then axis 2 transposed) or T^T
// (kTr true) of the component x at the point, each value first multiplied
// by the mask m where kMasked; o1, o2 the offsets along the two axes.
template <int K, bool kMasked, bool kTr>
__device__ __forceinline__ float2 avg2(const float2* __restrict__ x,
                                       const float* __restrict__ m,
                                       const int (&o1)[2 * K + 1],
                                       const int (&o2)[2 * K + 1],
                                       const float (&w)[2 * K]) {
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int u = 0; u < 2 * K; ++u) {
    const int t2 = u - (K - 1);
    const int base = o2[(kTr ? t2 : -t2) + K];
    float2 in = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 2 * K; ++t) {
      const int t1 = t - (K - 1);
      const int idx = base + o1[(kTr ? -t1 : t1) + K];
      float2 v = __ldg(x + idx);
      if (kMasked) v = rmul(__ldg(m + idx), v);
      const float2 term = rmul(w[t], v);
      in = t == 0 ? term : cadd(in, term);
    }
    const float2 term = rmul(w[u], in);
    acc = u == 0 ? term : cadd(acc, term);
  }
  return acc;
}

// The pair's block at the point (kTr false: the row block on x_in = x_col,
// added to y_row; true: its conjugate transpose on x_in = x_row, added to
// y_col): m_out T x_in + T (m_in x_in), as the eager composition orders it.
template <int K, bool kTr>
__device__ __forceinline__ float2 block(const float2* x_in, const float* m_in,
                                        const float* m_out,
                                        const int (&o1)[2 * K + 1],
                                        const int (&o2)[2 * K + 1],
                                        const float (&w)[2 * K]) {
  const float2 f =
      rmul(__ldg(m_out), avg2<K, false, kTr>(x_in, m_in, o1, o2, w));
  return cadd(f, avg2<K, true, kTr>(x_in, m_in, o1, o2, w));
}

// kPairs: the nonzero pairs, bit 0 pair 12, bit 1 pair 13, bit 2 pair 23;
// each instance holds only their code, so its registers are what they need.
template <int K, int kPairs>
__global__ void __launch_bounds__(kThreads)
crossdof_kernel(const Problem p) {
  const int g = blockIdx.x / p.point_blocks;
  const long long pt =
      (long long)(blockIdx.x - g * p.point_blocks) * kThreads + threadIdx.x;
  const int c0 = g * p.group;
  const int c1 = min(p.cols, c0 + p.group);
  const long long V = p.V;
  if (pt >= V || c0 >= c1) return;
  const int n = p.n;
  const int ck = (int)(pt % n);
  const long long r = pt / n;
  const int cj = (int)(r % n), ci = (int)(r / n);
  int oi[2 * K + 1], oj[2 * K + 1], ok[2 * K + 1];
  offsets<K>(ci, n, n * n, oi);
  offsets<K>(cj, n, n, oj);
  offsets<K>(ck, n, 1, ok);
  float w[2 * K];
#pragma unroll
  for (int u = 0; u < 2 * K; ++u) w[u] = p.w[u];
  const float* m = p.masks + pt;
  const float* d = p.diag + pt;
  for (int col = c0; col < c1; ++col) {
    const float2* x = p.x + (long long)col * 3 * V + pt;
    float2 y[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      y[q] = rmul(__ldg(d + q * V), __ldg(x + q * V));
    if constexpr ((kPairs & 1) != 0) {  // pair 12: along k, then j
      y[0] = cadd(y[0], cmul(p.alpha[0], block<K, false>(x + V, m + V, m,
                                                         ok, oj, w)));
      y[1] = cadd(y[1], cmul(cconj(p.alpha[0]),
                             block<K, true>(x, m, m + V, ok, oj, w)));
    }
    if constexpr ((kPairs & 2) != 0) {  // pair 13: along k, then i
      y[0] = cadd(y[0], cmul(p.alpha[1], block<K, false>(x + 2 * V,
                                                         m + 2 * V, m, ok,
                                                         oi, w)));
      y[2] = cadd(y[2], cmul(cconj(p.alpha[1]),
                             block<K, true>(x, m, m + 2 * V, ok, oi, w)));
    }
    if constexpr ((kPairs & 4) != 0) {  // pair 23: along j, then i
      y[1] = cadd(y[1], cmul(p.alpha[2], block<K, false>(x + 2 * V,
                                                         m + 2 * V, m + V,
                                                         oj, oi, w)));
      y[2] = cadd(y[2], cmul(cconj(p.alpha[2]),
                             block<K, true>(x + V, m + V, m + 2 * V, oj, oi,
                                            w)));
    }
    float2* out = p.y + (long long)col * 3 * V + pt;
#pragma unroll
    for (int q = 0; q < 3; ++q) out[q * V] = y[q];
  }
}

using Kernel = void (*)(Problem);

template <int K>
Kernel pick(int pairs) {
  switch (pairs) {
    case 0: return crossdof_kernel<K, 0>;
    case 1: return crossdof_kernel<K, 1>;
    case 2: return crossdof_kernel<K, 2>;
    case 3: return crossdof_kernel<K, 3>;
    case 4: return crossdof_kernel<K, 4>;
    case 5: return crossdof_kernel<K, 5>;
    case 6: return crossdof_kernel<K, 6>;
    default: return crossdof_kernel<K, 7>;
  }
}

// The instance for 2k taps and these pairs.
Kernel kernel_for(int k, int pairs) {
  return k == 1 ? pick<1>(pairs) : (k == 2 ? pick<2>(pairs) : pick<3>(pairs));
}

// The card's SMs times the blocks of `kernel` one SM holds at once.
cudaError_t slots(Kernel kernel, int* out) {
  // per instance, for the last device this thread asked on: the occupancy
  // query costs more host time than the launch
  constexpr int kInstances = 3 * 8;
  thread_local Kernel seen[kInstances] = {};
  thread_local int dev_of[kInstances], slots_of[kInstances];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int i = 0;
  while (i < kInstances && seen[i] != nullptr && seen[i] != kernel) ++i;
  if (i == kInstances) i = 0;
  if (seen[i] == kernel && dev_of[i] == dev) {
    *out = slots_of[i];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  seen[i] = kernel;
  dev_of[i] = dev;
  slots_of[i] = sms * per_sm;
  *out = slots_of[i];
  return cudaSuccess;
}

int launch(Problem& p, int k, cudaStream_t st) {
  const Kernel kernel = kernel_for(k, p.active);
  int fill_slots = 0;
  const cudaError_t e = slots(kernel, &fill_slots);
  if (e != cudaSuccess) return (int)e;
  // Split the columns into the fewest groups whose blocks fill 90% of the
  // last wave of resident slots (the best split up to 16 groups if none).
  p.point_blocks = (int)((p.V + kThreads - 1) / kThreads);
  const int most = p.cols < 16 ? p.cols : 16;
  int groups = 1;
  double best = -1.0;
  for (int gc = 1; gc <= most; ++gc) {
    const long long blocks = (long long)p.point_blocks * gc;
    const long long waves = (blocks + fill_slots - 1) / fill_slots;
    const double fill = (double)blocks / ((double)waves * fill_slots);
    if (fill > best + 1e-9) {
      best = fill;
      groups = gc;
    }
    if (fill >= 0.9) break;
  }
  p.group = (p.cols + groups - 1) / groups;
  groups = (p.cols + p.group - 1) / p.group;
  const long long grid = (long long)p.point_blocks * groups;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: x, diag, masks, y.  meta: N, cols, k, active pairs (bit 0: 12,
// bit 1: 13, bit 2: 23).  params: the 2k taps (6 slots), then (re, im) of
// 0.5 e for pairs 12, 13, 23.  x and y (cols, 3, N^3) complex64, diag and
// masks (3, N^3) float32, all contiguous.  Launches on `stream` and returns
// the cudaError_t (0 on success).
extern "C" int pcx_crossdof(const void* const* ptrs, const long long* meta,
                            const float* params, void* stream) {
  Problem p;
  p.x = (const float2*)ptrs[0];
  p.diag = (const float*)ptrs[1];
  p.masks = (const float*)ptrs[2];
  p.y = (float2*)ptrs[3];
  const long long n = meta[0], cols = meta[1], k = meta[2];
  if (p.x == nullptr || p.diag == nullptr || p.masks == nullptr ||
      p.y == nullptr || n < 1 || n > 1290 || cols < 1 || cols > (1 << 30) ||
      k < 1 || k > kMaxK || meta[3] < 0 || meta[3] > 7)
    return (int)cudaErrorInvalidValue;
  p.n = (int)n;
  p.V = n * n * n;
  p.cols = (int)cols;
  p.active = (int)meta[3];
  for (int u = 0; u < 2 * kMaxK; ++u) p.w[u] = params[u];
  for (int a = 0; a < 3; ++a)
    p.alpha[a] = make_float2(params[2 * kMaxK + 2 * a],
                             params[2 * kMaxK + 2 * a + 1]);
  return launch(p, (int)k, (cudaStream_t)stream);
}

// The blocks of the kernel for 2k taps and these pairs that one SM holds
// at once, or minus a cudaError_t.
extern "C" int pcx_crossdof_blocks(int k, int pairs) {
  if (k < 1 || k > kMaxK || pairs < 0 || pairs > 7)
    return -(int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel_for(k, pairs), kThreads, 0);
  return e == cudaSuccess ? per_sm : -(int)e;
}
