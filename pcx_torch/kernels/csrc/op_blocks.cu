// K5: the operator's curl and penalty block multiplies around K2, written by
// hand for Hopper.
//
// Replaces no Pallas kernel: the JAX package writes the 3x3 block multiplies
// of its operator (`a_block_p`, `h_block_p` in `ama_p` and `ama_bb_p`,
// pcx/operators/rs.py:87-110, :228-248) as pair arithmetic that XLA fuses
// into one loop each.  On the card the port ran them as eager PyTorch: every
// complex product, sum and `torch.stack` its own kernel with its own
// temporary, about 40 block-sized reads and writes in a 16-column apply where
// the function needs 5.  K5 computes each side of K2 in one streaming pass:
//   pre:  y   = A(-conj d) x                        (before the forward DFT)
//   post: out = A(d) z  [+ H(b) x + sigma x]         (after the inverse DFT)
// with A(d) = [[0,-d2,d1],[d2,0,-d0],[-d1,d0,0]] (blocks.a_block), H(b) the
// Hermitian block of real diagonal bd and complex off-diagonal bs
// (blocks.h_block), z the inverse DFT's output, and the bracket, the
// penalty and the shift of `ama_bb`, a template flag (`ama` leaves it out).
// The negated conjugate symbol of pre is formed in registers.
//
// The same bits as the eager composition: each product and sum is rounded
// to f32 where PyTorch rounds it and in its order -- a_block d1*x2 - d2*x1,
// h_block (bd0*x0 + bs0*x1) + bs1*x2, ama_bb (A z + H x) + sigma x -- by
// explicit round-to-nearest intrinsics, which nvcc does not contract, and a
// complex product in the form of PyTorch's complex64 multiply on the card
// (`cmul`).  A real factor (the diagonal, the shift) times a complex value
// rounds each part once, as PyTorch's product of the promoted (r, 0) does.
//
// What bounds it on an H100: the bytes.  At m=16, N=120 (V = 24 N^3 bytes:
// one column, or one complex symbol) pre reads 16 columns and the symbol and
// writes 16 columns, 33 V = 1.37 GB, 0.41 ms at 3.35 TB/s; post with the
// penalty reads z, x, d, bd (half a V) and bs and writes 16 columns, 50.5 V
// = 2.09 GB, 0.63 ms.  Its ~114 FLOP a grid point and column (72 bytes)
// lie far below the card's balance point of ~20 FLOP a byte.  Design: a
// block of 256 threads owns a tile of 512 grid points (two a thread:
// 16-byte loads, or one a thread with 8-byte loads where V is odd or an
// operand is not 16-byte aligned) and walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; the grid is sized to the resident blocks.
// For each lane of symbols a thread loads its points' symbol entries once
// into registers, then streams its points of every column of that lane, so
// an apply reads each symbol once, not once per column.  No shared memory
// and no reduction: an output element depends only on its own point and
// column, so the result does not depend on the grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Kind { kPre = 0, kAma = 1, kAmaBB = 2 };

struct Problem {
  const float2* x;       // pre: the block; post: the penalty's block
  const float2* z;       // post: the inverse DFT's output
  const float2* d;       // curl symbol (S, 3, V)
  const float* bd;       // penalty diagonal (S, 3, V), real
  const float2* bs;      // penalty off-diagonal (S, 3, V)
  const float* shifts;   // (S,), or null: `shift` for every lane
  float2* out;           // (S * cols, 3, V), like x and z
  long long V;
  float shift;
  int cols;              // columns per symbol lane
  int lanes;             // symbol lanes S
  bool has_shift;
};

// The complex product a * b as PyTorch's complex64 multiply rounds it on
// the card: (a.x b.x - a.y b.y, a.x b.y + a.y b.x) with the first product
// of each part fused.
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

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}

// kPer consecutive complex values (16 or 8 bytes), through the read-only
// path: nothing a launch reads is written by it.
template <int kPer>
__device__ __forceinline__ void load(const float2* p, float2 (&v)[kPer]) {
  if constexpr (kPer == 2) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = make_float2(t.x, t.y);
    v[1] = make_float2(t.z, t.w);
  } else {
    v[0] = __ldg(p);
  }
}

template <int kPer>
__device__ __forceinline__ void load(const float* p, float (&v)[kPer]) {
  if constexpr (kPer == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kPer>
__device__ __forceinline__ void store(float2* p, const float2 (&v)[kPer]) {
  if constexpr (kPer == 2)
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
  else
    *p = v[0];
}

// y = A(d) x, blocks.a_block's order: y0 = d1 x2 - d2 x1, y1 = d2 x0 - d0 x2,
// y2 = d0 x1 - d1 x0.
__device__ __forceinline__ void curl(const float2 (&d)[3],
                                     const float2 (&x)[3], float2 (&y)[3]) {
  y[0] = csub(cmul(d[1], x[2]), cmul(d[2], x[1]));
  y[1] = csub(cmul(d[2], x[0]), cmul(d[0], x[2]));
  y[2] = csub(cmul(d[0], x[1]), cmul(d[1], x[0]));
}

// y += H(b) x, blocks.h_block's order: h0 = (bd0 x0 + bs0 x1) + bs1 x2,
// h1 = (conj(bs0) x0 + bd1 x1) + bs2 x2, h2 = (conj(bs1) x0 + conj(bs2) x1)
// + bd2 x2, then y + h.
__device__ __forceinline__ void add_penalty(const float (&bd)[3],
                                            const float2 (&bs)[3],
                                            const float2 (&x)[3],
                                            float2 (&y)[3]) {
  const float2 h0 =
      cadd(cadd(rmul(bd[0], x[0]), cmul(bs[0], x[1])), cmul(bs[1], x[2]));
  const float2 h1 = cadd(cadd(cmul(cconj(bs[0]), x[0]), rmul(bd[1], x[1])),
                         cmul(bs[2], x[2]));
  const float2 h2 = cadd(
      cadd(cmul(cconj(bs[1]), x[0]), cmul(cconj(bs[2]), x[1])),
      rmul(bd[2], x[2]));
  y[0] = cadd(y[0], h0);
  y[1] = cadd(y[1], h1);
  y[2] = cadd(y[2], h2);
}

template <int kKind, int kPer>
__global__ void __launch_bounds__(kThreads)
op_blocks_kernel(const Problem pr) {
  constexpr int kTile = kThreads * kPer;
  const long long V = pr.V;
  const long long ntiles = (V + kTile - 1) / kTile;
  const float2* __restrict__ src = kKind == kPre ? pr.x : pr.z;
  const float2* __restrict__ xs = pr.x;
  float2* __restrict__ out = pr.out;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kTile + (long long)threadIdx.x * kPer;
    if (i >= V) continue;  // kPer = 2 only for an even V: both points or none
    for (int s = 0; s < pr.lanes; ++s) {
      const long long so = (long long)s * 3 * V + i;
      float2 d[3][kPer];
#pragma unroll
      for (int c = 0; c < 3; ++c) load<kPer>(pr.d + so + c * V, d[c]);
      if (kKind == kPre) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            d[c][e] = make_float2(-d[c][e].x, d[c][e].y);  // -conj(d), exact
      }
      float bd[3][kPer];
      float2 bs[3][kPer];
      float sigma = 0.f;
      if (kKind == kAmaBB) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          load<kPer>(pr.bd + so + c * V, bd[c]);
          load<kPer>(pr.bs + so + c * V, bs[c]);
        }
        sigma = pr.shifts != nullptr ? __ldg(pr.shifts + s) : pr.shift;
      }
      for (int j = 0; j < pr.cols; ++j) {
        const long long co = ((long long)s * pr.cols + j) * 3 * V + i;
        float2 v[3][kPer], x[3][kPer], y[3][kPer];
#pragma unroll
        for (int c = 0; c < 3; ++c) load<kPer>(src + co + c * V, v[c]);
        if (kKind == kAmaBB) {
#pragma unroll
          for (int c = 0; c < 3; ++c) load<kPer>(xs + co + c * V, x[c]);
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const float2 de[3] = {d[0][e], d[1][e], d[2][e]};
          const float2 ve[3] = {v[0][e], v[1][e], v[2][e]};
          float2 ye[3];
          curl(de, ve, ye);
          if (kKind == kAmaBB) {
            const float bde[3] = {bd[0][e], bd[1][e], bd[2][e]};
            const float2 bse[3] = {bs[0][e], bs[1][e], bs[2][e]};
            const float2 xe[3] = {x[0][e], x[1][e], x[2][e]};
            add_penalty(bde, bse, xe, ye);
            if (pr.has_shift) {
#pragma unroll
              for (int c = 0; c < 3; ++c)
                ye[c] = cadd(ye[c], rmul(sigma, xe[c]));
            }
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c][e] = ye[c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) store<kPer>(out + co + c * V, y[c]);
      }
    }
  }
}

template <int kKind, int kPer>
int launch(const Problem& pr, cudaStream_t st) {
  auto kernel = op_blocks_kernel<kKind, kPer>;
  // The resident blocks on the last device this thread launched this
  // instance on: the occupancy query costs more host time than the launch.
  thread_local int last_dev = -1, last_slots = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_slots = sms * per_sm;
  }
  constexpr int kTile = kThreads * kPer;
  const long long ntiles = (pr.V + kTile - 1) / kTile;
  // as many tiles for every block: no block walks one tile more at the end
  const long long per = (ntiles + last_slots - 1) / last_slots;
  const long long grid = (ntiles + per - 1) / per;
  kernel<<<(unsigned)grid, kThreads, 0, st>>>(pr);
  return (int)cudaGetLastError();
}

template <int kKind>
int dispatch(const Problem& pr, bool vec, cudaStream_t st) {
  return vec ? launch<kKind, 2>(pr, st) : launch<kKind, 1>(pr, st);
}

bool aligned(const void* p, unsigned long long to) {
  return (reinterpret_cast<unsigned long long>(p) & (to - 1)) == 0;
}

}  // namespace

// ptrs: x, z, d, bd, bs, shifts, out (null where absent: pre reads x and d;
// post without the penalty z and d; post with it z, x, d, bd and bs, and
// the lanes' shifts where `shifts` is not null, else `shift`).
// meta: kind (0 pre, 1 post, 2 post with the penalty), V = N^3, columns
// per symbol lane, symbol lanes, has_shift.  Every operand contiguous:
// blocks (lanes * cols, 3, V), symbols (lanes, 3, V).  Launches on `stream`
// and returns the cudaError_t (0 on success).
extern "C" int pcx_op_blocks(const void* const* ptrs, const long long* meta,
                             float shift, void* stream) {
  Problem pr;
  pr.x = (const float2*)ptrs[0];
  pr.z = (const float2*)ptrs[1];
  pr.d = (const float2*)ptrs[2];
  pr.bd = (const float*)ptrs[3];
  pr.bs = (const float2*)ptrs[4];
  pr.shifts = (const float*)ptrs[5];
  pr.out = (float2*)ptrs[6];
  const long long kind = meta[0];
  pr.V = meta[1];
  pr.shift = shift;
  pr.has_shift = meta[4] != 0;
  if (kind < kPre || kind > kAmaBB || pr.V < 1 || meta[2] < 1 ||
      meta[2] > (1 << 30) || meta[3] < 1 || meta[3] > (1 << 30) ||
      pr.d == nullptr || pr.out == nullptr)
    return (int)cudaErrorInvalidValue;
  pr.cols = (int)meta[2];
  pr.lanes = (int)meta[3];
  const bool pen = kind == kAmaBB;
  if ((kind == kPre || pen) && pr.x == nullptr)
    return (int)cudaErrorInvalidValue;
  if (kind != kPre && pr.z == nullptr) return (int)cudaErrorInvalidValue;
  if (pen && (pr.bd == nullptr || pr.bs == nullptr))
    return (int)cudaErrorInvalidValue;
  // two points a thread: every row starts 16 bytes apart from an aligned
  // base (8 for the real diagonal)
  bool vec = pr.V % 2 == 0 && aligned(pr.d, 16) && aligned(pr.out, 16);
  if (kind == kPre || pen) vec = vec && aligned(pr.x, 16);
  if (kind != kPre) vec = vec && aligned(pr.z, 16);
  if (pen) vec = vec && aligned(pr.bd, 8) && aligned(pr.bs, 16);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == kPre) return dispatch<kPre>(pr, vec, st);
  if (kind == kAma) return dispatch<kAma>(pr, vec, st);
  return dispatch<kAmaBB>(pr, vec, st);
}
