// K2: one axis pass of the 3-D DFT, as a mixed-radix FFT in shared memory.
//
// Replaces the Pallas TPU kernel `_axis_dft_kernel` and its wrapper
// `axis_dft_pairs` (pcx/operators/pallas_kernels.py:288, :323).  One pass maps
// x (B, A, J, K) -> y (B, J, K, A), complex64 (float2):
//
//   y[b, j, k, c] = s * sum_a x[b, a, j, k] exp(sigma 2 pi i a c / A),
//
// sigma = -1, s = 1 forward; sigma = +1, s = 1/A inverse.  It transforms the
// -3rd axis and writes it last, so three passes make a 3-D DFT and restore
// the axis order.  The TPU kernel contracts x with the dense (A, A) twiddle
// because the TPU's FFT lowers to reduced-precision passes; this card has
// IEEE f32 on its CUDA cores, so the pass is an FFT.
//
// Algorithm (one length-A line per (b, j, k)).  A = N1 * N2 with N1 <= N2 <=
// 16 the divisor pair nearest sqrt(A) (the host's plan, axis_dft.py); input
// index a = N2 a1 + a2, output index c = c1 + N1 c2:
//   1. N2 DFTs of length N1 along a1, each output times the twiddle
//      tw[a2][c1] = s exp(sigma 2 pi i a2 c1 / A)   (the 1/A lives here only);
//   2. N1 DFTs of length N2 along a2.
// A small DFT of length L runs in registers on the pairs (a, L - a): with
// s_a = v[a] + v[L-a] and d_a = v[a] - v[L-a], out[c] and out[L-c] share the
// products s_a Re w[ac] and d_a Im w[ac], 4 f32 FMAs per (a, c) pair instead
// of 16.  An A with no such pair (a prime or a factor above 16) runs one dense
// stage of length A from shared memory (N1 = A, N2 = 1): slower, right.
// All arithmetic is IEEE f32 FMA on the CUDA cores; no TF32, no tensor core.
//
// What bounds it on an H100, B=48, N=120: 1.327 GB read and written once,
// 0.396 ms at 3.35 TB/s; the plan (10 x 12) does 47.6 flop per output, 3.95
// GFLOP, 0.06 ms at the f32 peak.  So the pass is bound by its bytes, and
// the design moves each byte once:
//   * a block owns tiles of 32 lines: (b, j, k0:k0+32) with the whole A
//     axis, or (b, j0:j0+jt, all K) when K is short.  The input slab
//     x[b, :, j0:j0+jt, k0:k0+kt] is one 3-D TMA box over x viewed as
//     (B*A, J, K), completed on an mbarrier;
//   * a persistent grid (as many blocks as fit on the SMs: two per SM for
//     N <= 144, one at N=150) walks the tiles with a 2-deep ring of input
//     slabs: the next tile's load is in flight while this one computes, and
//     a slab is refilled as soon as it is read, before the tile's stores;
//   * stage 1 runs in place on the slab (columns of a line are `lines`
//     apart: conflict-free), stage 2 writes the transposed output tile
//     [line][c] with an odd row stride (conflict-free), and the tile leaves
//     as one contiguous run of y with 16-byte streaming stores.
// The loads skip the L2 promotion and the stores stream (evict-first).
// `python3 -m pcx_torch.k2_variants` times the alternatives (L2 promotion,
// cached stores, 16-line or K-dividing tiles, a 3-deep ring, cp.async
// loads) against these choices: none wins at every N of the paths, and a
// pass without the FFT at all runs no faster -- the transposing data
// movement, not the arithmetic, sets the time.
// Where TMA cannot take x (its row stride K*8 bytes or its address not a
// multiple of 16: an odd K, as the coarse N=75 grid), the same kernel loads
// the slab with 8-byte cp.async into the same ring.  The host encodes the
// tensor map at every launch (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: no link against libcuda).

#include <cuda.h>
#include <cuda_runtime.h>

#include <chrono>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxA = 256;      // the TMA box limit, and the dense stage's
constexpr int kMaxRadix = 16;   // register DFTs of length 1..16
constexpr int kStages = 2;      // input slabs in flight per block
constexpr int kLines = 32;      // lines per tile

struct Params {
  const float2* x;
  float2* y;
  const float2* w1;  // exp(sigma 2 pi i m / N1), m < N1
  const float2* tw;  // s exp(sigma 2 pi i a2 c1 / A), [a2][c1]
  const float2* w2;  // exp(sigma 2 pi i m / N2), m < N2
  int A, J, K;
  int n1, n2;
  int jt, kt, lines;  // tile: jt rows of j x kt columns of k (jt > 1 only
                      // when kt == K)
  int nj, nk;         // tiles along j and k
  long long tiles;
  int s_out;          // output tile row stride, odd
  int slab;           // complex per input slab, a multiple of 16
};

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// In place on v[0..L): v <- DFT_L(v), w[m] = exp(sigma 2 pi i m / L).
template <int L>
__device__ __forceinline__ void dft_line(float2 (&v)[kMaxRadix],
                                         const float2 (&w)[kMaxRadix]) {
  constexpr int H = (L - 1) / 2;  // pairs (a, L - a), a = 1..H
  constexpr bool kEven = L % 2 == 0;
  float2 s[H + 1], d[H + 1];
#pragma unroll
  for (int a = 1; a <= H; ++a) {
    s[a] = v[a] + v[L - a];
    d[a] = v[a] - v[L - a];
  }
  float2 out[kMaxRadix];
  float2 acc = v[0];
#pragma unroll
  for (int a = 1; a <= H; ++a) acc = acc + s[a];
  if (kEven) acc = acc + v[L / 2];
  out[0] = acc;
  if (kEven) {  // c = L/2: w[a L/2 mod L] = (-1)^a
    float2 e = v[0];
#pragma unroll
    for (int a = 1; a <= H; ++a) e = (a & 1) ? e - s[a] : e + s[a];
    e = ((L / 2) & 1) ? e - v[L / 2] : e + v[L / 2];
    out[L / 2] = e;
  }
#pragma unroll
  for (int c = 1; c <= H; ++c) {
    float2 re = v[0], im = make_float2(0.f, 0.f);
    if (kEven) re = (c & 1) ? re - v[L / 2] : re + v[L / 2];
#pragma unroll
    for (int a = 1; a <= H; ++a) {
      const float2 t = w[(a * c) % L];
      re.x = fmaf(s[a].x, t.x, re.x);
      re.y = fmaf(s[a].y, t.x, re.y);
      im.x = fmaf(d[a].x, t.y, im.x);
      im.y = fmaf(d[a].y, t.y, im.y);
    }
    // out[c] = re + i im, out[L - c] = re - i im
    out[c] = make_float2(re.x - im.y, re.y + im.x);
    out[L - c] = make_float2(re.x + im.y, re.y - im.x);
  }
#pragma unroll
  for (int c = 0; c < L; ++c) v[c] = out[c];
}

// Stage 1 on the slab X[a][line] (row stride `lines`), in place: for each
// (a2, line), the length-N1 DFT over a1 of X[N2 a1 + a2], times tw[a2][c1],
// back to X[N2 c1 + a2].  Each item reads and writes only its own cells.
template <int L>
__device__ __forceinline__ void stage1(float2* X, const float2* w1s,
                                       const float2* tws, int n2,
                                       int lines) {
  float2 w[kMaxRadix];
#pragma unroll
  for (int m = 0; m < L; ++m) w[m] = w1s[m];
  const int step = n2 * lines;
  for (int it = threadIdx.x; it < n2 * lines; it += kThreads) {
    const int a2 = it / lines;
    float2* col = X + it;  // X[a2][q]: it = a2 * lines + q
    float2 v[kMaxRadix];
#pragma unroll
    for (int a1 = 0; a1 < L; ++a1) v[a1] = col[a1 * step];
    dft_line<L>(v, w);
    const float2* t = tws + a2 * L;
#pragma unroll
    for (int c1 = 0; c1 < L; ++c1) col[c1 * step] = cmul(v[c1], t[c1]);
  }
}

// Stage 2: for each (c1, line), the length-N2 DFT over a2 of X[N2 c1 + a2],
// written to the output tile O[line][c1 + N1 c2].
template <int L>
__device__ __forceinline__ void stage2(const float2* X, float2* O,
                                       const float2* w2s, int n1, int lines,
                                       int s_out) {
  float2 w[kMaxRadix];
#pragma unroll
  for (int m = 0; m < L; ++m) w[m] = w2s[m];
  for (int it = threadIdx.x; it < n1 * lines; it += kThreads) {
    const int c1 = it / lines, q = it - c1 * lines;
    const float2* col = X + c1 * L * lines + q;
    float2 v[kMaxRadix];
#pragma unroll
    for (int a2 = 0; a2 < L; ++a2) v[a2] = col[a2 * lines];
    dft_line<L>(v, w);
    float2* o = O + q * s_out + c1;
#pragma unroll
    for (int c2 = 0; c2 < L; ++c2) o[c2 * n1] = v[c2];
  }
}

// One uniform branch per radix: the block's n1 / n2 pick the instance.
template <int L = 1>
__device__ __forceinline__ void run_stage1(int n1, float2* X,
                                           const float2* w1s,
                                           const float2* tws, int n2,
                                           int lines) {
  if constexpr (L <= kMaxRadix) {
    if (n1 == L)
      stage1<L>(X, w1s, tws, n2, lines);
    else
      run_stage1<L + 1>(n1, X, w1s, tws, n2, lines);
  }
}

template <int L = 1>
__device__ __forceinline__ void run_stage2(int n2, const float2* X,
                                           float2* O, const float2* w2s,
                                           int n1, int lines, int s_out) {
  if constexpr (L <= kMaxRadix) {
    if (n2 == L)
      stage2<L>(X, O, w2s, n1, lines, s_out);
    else
      run_stage2<L + 1>(n2, X, O, w2s, n1, lines, s_out);
  }
}

// The dense stage (A with no radix pair): O[line][c] = tw[c] sum_a
// X[a][line] w1[a c mod A].
__device__ __forceinline__ void stage_dense(const float2* X, float2* O,
                                            const float2* w1s,
                                            const float2* tws, int A,
                                            int lines, int s_out) {
  for (int it = threadIdx.x; it < A * lines; it += kThreads) {
    const int c = it / lines, q = it - c * lines;
    float2 acc = make_float2(0.f, 0.f);
    int m = 0;
    for (int a = 0; a < A; ++a) {
      const float2 xv = X[a * lines + q], t = w1s[m];
      acc.x = fmaf(xv.x, t.x, fmaf(-xv.y, t.y, acc.x));
      acc.y = fmaf(xv.x, t.y, fmaf(xv.y, t.x, acc.y));
      m += c;
      if (m >= A) m -= A;
    }
    O[q * s_out + c] = cmul(acc, tws[c]);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

struct Tile {
  int b, j0, k0;
};

__device__ __forceinline__ Tile tile_at(const Params& p, long long t) {
  const long long per_b = (long long)p.nj * p.nk;
  const int b = (int)(t / per_b);
  const int r = (int)(t - b * per_b);
  const int jb = r / p.nk;
  return {b, jb * p.jt, (r - jb * p.nk) * p.kt};
}

// Start the load of tile t into `slab`: one TMA box on `bar` (thread 0), or
// 8-byte cp.async by every thread (zeros past J and K), one commit group.
template <bool kTma>
__device__ __forceinline__ void load_tile(const CUtensorMap& tmap,
                                          const Params& p, long long t,
                                          float2* slab,
                                          unsigned long long* bar) {
  if (kTma) {
    if (threadIdx.x != 0 || t >= p.tiles) return;
    const Tile tl = tile_at(p, t);
    const unsigned b = smem_addr(bar);
    // the slab was last read by generic loads; order them before the copy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
        "r"(p.A * p.lines * 8)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(slab)),
        "l"(reinterpret_cast<unsigned long long>(&tmap)), "r"(b),
        "r"(tl.k0), "r"(tl.j0), "r"(tl.b * p.A)
        : "memory");
  } else {
    if (t < p.tiles) {
      const Tile tl = tile_at(p, t);
      for (int e = threadIdx.x; e < p.A * p.lines; e += kThreads) {
        const int a = e / p.lines, q = e - a * p.lines;
        const int jj = q / p.kt;
        const int j = tl.j0 + jj, k = tl.k0 + q - jj * p.kt;
        const bool ok = j < p.J && k < p.K;
        const float2* src =
            ok ? p.x + (((long long)tl.b * p.A + a) * p.J + j) * p.K + k
               : p.x;
        asm volatile(
            "cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                smem_addr(slab + e)),
            "l"(src), "r"(ok ? 8 : 0)
            : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
axis_dft_kernel(const __grid_constant__ CUtensorMap tmap, const Params p) {
  // Dynamic shared memory only, so the slabs start 128-byte aligned (TMA).
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float2* slabs = reinterpret_cast<float2*>(smem_raw);
  float2* out = slabs + kStages * p.slab;
  float2* w1s = out + p.lines * p.s_out;
  float2* tws = w1s + p.n1;
  float2* w2s = tws + p.n1 * p.n2;
  auto* bars = reinterpret_cast<unsigned long long*>(w2s + p.n2);
  for (int i = threadIdx.x; i < p.n1; i += kThreads) w1s[i] = p.w1[i];
  for (int i = threadIdx.x; i < p.n1 * p.n2; i += kThreads) tws[i] = p.tw[i];
  for (int i = threadIdx.x; i < p.n2; i += kThreads) w2s[i] = p.w2[i];
  if (kTma && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&bars[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long g = gridDim.x;
  long long tile = blockIdx.x;
  for (int s = 0; s < kStages; ++s)
    load_tile<kTma>(tmap, p, tile + s * g, slabs + s * p.slab, &bars[s]);
  const bool vec = p.A % 2 == 0 &&
                   (reinterpret_cast<unsigned long long>(p.y) & 15) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int it = 0; tile < p.tiles; tile += g, ++it) {
    const int s = it % kStages;
    float2* X = slabs + s * p.slab;
    if (kTma) {
      mbar_wait(smem_addr(&bars[s]), (it / kStages) & 1);
    } else {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                   : "memory");
      __syncthreads();
    }
    if (p.n1 > kMaxRadix) {
      __syncthreads();  // the previous tile's stores have read `out`
      stage_dense(X, out, w1s, tws, p.A, p.lines, p.s_out);
    } else {
      run_stage1(p.n1, X, w1s, tws, p.n2, p.lines);
      __syncthreads();
      run_stage2(p.n2, X, out, w2s, p.n1, p.lines, p.s_out);
    }
    __syncthreads();
    // The slab is read: refill it with the tile kStages ahead before this
    // tile's stores, which would otherwise hold the load back.
    load_tile<kTma>(tmap, p, tile + kStages * g, X, &bars[s]);

    // The tile's lines are one contiguous run of y: lines (b, j0 + q / kt,
    // k0 + q % kt) with jt == 1 or kt == K.
    const Tile tl = tile_at(p, tile);
    const int valid = p.jt == 1 ? min(p.kt, p.K - tl.k0)
                                : min(p.jt, p.J - tl.j0) * p.K;
    float2* yt = p.y + (((long long)tl.b * p.J + tl.j0) * p.K + tl.k0) * p.A;
    if (vec) {
      const int pairs = p.A / 2;
      for (int q = warp; q < valid; q += kThreads / 32) {
        const float2* o = out + q * p.s_out;
        float4* yr = reinterpret_cast<float4*>(yt + (long long)q * p.A);
        for (int e = lane; e < pairs; e += 32) {
          const float2 u = o[2 * e], v = o[2 * e + 1];
          __stcs(yr + e, make_float4(u.x, u.y, v.x, v.y));
        }
      }
    } else {
      for (int q = warp; q < valid; q += kThreads / 32) {
        const float2* o = out + q * p.s_out;
        float2* yr = yt + (long long)q * p.A;
        for (int e = lane; e < p.A; e += 32) __stcs(yr + e, o[e]);
      }
    }
  }
  if (!kTma) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// x viewed as (B*A, J, K) 8-byte elements, box (kt, jt, A).
int encode(CUtensorMap* map, const Params& p, int B) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)p.K, (cuuint64_t)p.J,
                              (cuuint64_t)B * p.A};
  const cuuint64_t strides[2] = {(cuuint64_t)p.K * 8,
                                 (cuuint64_t)p.J * p.K * 8};
  const cuuint32_t box[3] = {(cuuint32_t)p.kt, (cuuint32_t)p.jt,
                             (cuuint32_t)p.A};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3,
                        const_cast<float2*>(p.x), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int smem_bytes(const Params& p) {
  return 8 * (kStages * p.slab + p.lines * p.s_out + p.n1 + p.n1 * p.n2 +
              p.n2 + kStages);  // the slabs, `out`, the tables, the mbarriers
}

// The tiling: kLines lines per tile (at A = 256, 201 KB of shared memory).
Params plan(const float2* x, float2* y, const float2* w1, const float2* tw,
            const float2* w2, int B, int A, int J, int K, int n1, int n2) {
  Params p{};
  p.x = x, p.y = y, p.w1 = w1, p.tw = tw, p.w2 = w2;
  p.A = A, p.J = J, p.K = K, p.n1 = n1, p.n2 = n2;
  p.s_out = A | 1;
  if (K >= kLines) {
    p.kt = kLines, p.jt = 1;
  } else {
    p.kt = K, p.jt = min(J, max(1, kLines / K));
  }
  p.lines = p.jt * p.kt;
  p.slab = (A * p.lines + 15) & ~15;
  p.nj = (J + p.jt - 1) / p.jt;
  p.nk = (K + p.kt - 1) / p.kt;
  p.tiles = (long long)B * p.nj * p.nk;
  return p;
}

bool tma_ok(const Params& p) {
  return (reinterpret_cast<unsigned long long>(p.x) & 15) == 0 &&
         (p.K * 8) % 16 == 0 && (p.kt * 8) % 16 == 0;
}

// Writes the blocks resident per SM, as the occupancy query gave them, to
// `per_sm_out`.
template <bool kTma>
int launch(const CUtensorMap& map, const Params& p, cudaStream_t stream,
           int* per_sm_out) {
  auto kernel = axis_dft_kernel<kTma>;
  const int smem = smem_bytes(p);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *per_sm_out = per_sm;
  const long long fit = (long long)per_sm * sms;
  const long long grid = p.tiles < fit ? p.tiles : fit;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: complex64 (B, A, J, K) contiguous; y: complex64 (B, J, K, A) contiguous;
// w1 (n1), tw (n2, n1), w2 (n2): the plan's f32 tables (axis_dft.py).
// n1 * n2 == A with n1, n2 <= 16, or n1 == A, n2 == 1 for the dense stage;
// A <= 256.  Launches on `stream`; returns the cudaError_t of the set-up and
// the launch (0 on success), and writes the launch's resident blocks per SM
// to `per_sm`.
extern "C" int pcx_axis_dft(const void* x, void* y, const void* w1,
                            const void* tw, const void* w2, int B, int A,
                            int J, int K, int n1, int n2, void* stream,
                            int* per_sm) {
  if (B <= 0 || A <= 0 || J <= 0 || K <= 0 || A > kMaxA || n1 <= 0 ||
      n2 <= 0 || n1 * n2 != A || (n1 > kMaxRadix && n2 != 1) ||
      n2 > kMaxRadix)
    return (int)cudaErrorInvalidValue;
  const Params p = plan((const float2*)x, (float2*)y, (const float2*)w1,
                        (const float2*)tw, (const float2*)w2, B, A, J, K, n1,
                        n2);
  if (p.tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap map{};
  if (tma_ok(p)) {
    const int e = encode(&map, p, B);
    if (e) return e;
    return launch<true>(map, p, st, per_sm);
  }
  return launch<false>(map, p, st, per_sm);
}

// Host cost of the per-launch tensor-map encode: mean microseconds of `reps`
// encodes of the map pcx_axis_dft would build for this shape (no launch);
// negative if TMA cannot take it.
extern "C" double pcx_axis_dft_encode_us(const void* x, int B, int A, int J,
                                         int K, int reps) {
  const Params p = plan((const float2*)x, nullptr, nullptr, nullptr, nullptr,
                        B, A, J, K, 1, 1);
  if (reps <= 0 || !tma_ok(p) || !encode_tiled()) return -1.0;
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (encode(&map, p, B)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}
