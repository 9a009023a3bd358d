// K4: the dense algebra's block combinations, written by hand for Hopper.
//
// Replaces no Pallas kernel: the JAX package leaves its block combinations
// (`mix_pair` and the projections of pcx/solvers/rayleigh_ritz.py) to XLA.
// It exists because on the card each combination was a cuBLAS GEMM, at half
// its bytes bound, plus eager passes: a projection `block - mix(coeff, base)`
// wrote the product and read it back for the subtraction, and the bases of
// the second SVQB were concatenated first ([X|W], [HX|HW]).  For lanes l it
// computes
//   out[l] = A[l] + sum_b C_b[l]^T B_b[l]
// with up to three input blocks B_b (L, p_b, D) complex64, each read where
// it lies (D contiguous, any row and lane stride), coefficients C_b
// (L, p_b, q) with any strides, and an optional addend A (L, q, D) added
// last; with `sub` the coefficients enter negated (exact), so A - sum keeps
// the order of operations of the subtraction it replaces.
//
// Arithmetic: IEEE f32 FMAs on the CUDA cores, as cuBLAS's cgemm (TF32
// off); a complex product is four real FMAs, the sum over the rows runs in
// row order in registers.
//
// What bounds it on an H100: the bytes.  At m=16, N=120 (D = 3*120^3) the
// Rayleigh-Ritz update X' = [X|W|P] C reads 48 rows and writes 16: 2.65 GB,
// 0.79 ms at 3.35 TB/s; its 8 rows q D = 31.9 GFLOP take 0.48 ms at the
// 67 TFLOP/s f32 peak, so the CUDA cores must run at 60% of their rate to
// keep up with the bytes (every call of the solvers lies at 8-12 FLOP a
// byte, the card's balance point at 20).
//
// Design: a block of 128 threads owns a tile of 512 D-columns and walks the
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the grid is sized to the
// resident blocks.  Each thread owns 4 columns of the tile (two 16-byte
// pieces, or four 8-byte ones where an operand is not 16-byte aligned) and
// streams the rows of every input block, then the q rows of A, through a
// 4-deep ring of shared memory with cp.async; the ring runs across tile
// boundaries.  A thread reads back only the pieces it copied itself, so the
// ring needs no barrier, only cp.async.wait_group.  The q accumulators of
// its 4 columns sit in registers, and each coefficient (shared memory,
// broadcast to the warp) feeds 4 columns, so a row costs 16 q FMAs against
// q/2 + 2 shared loads.  Past 16 output rows the grid's z axis takes chunks
// of 16 (each chunk reads the inputs again).  No atomics, no reduction
// across blocks: an output element depends only on its own column, so the
// result does not depend on the grid.
//
// A scaled addend (`kScale`): the rs loop's W and P blocks enter their
// SVQB's projection as s * block, a real scale a row (the column norm's
// inverse times the active mask).  Rather than a pass that writes the
// scaled copy, K4 takes s (one float32 a row of A, any lane and row
// stride) and multiplies each addend element by its row's scale as it
// adds it, in its own rounding: __fmul_rn, then the add, never contracted
// into an FMA.  The eager complex-by-real product rounds each part once,
// so the sum equals the launch on the materialised s * A bit for bit, and
// the copy is neither written nor read.  The unscaled launch is the
// kScale = false instance, today's code.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;                   // columns of a tile per thread
constexpr int kTile = kThreads * kPer;    // columns of D per tile
constexpr int kStages = 4;                // ring depth, in rows: 3-8
                                          // time alike, 8 2-5% slower
constexpr int kMaxBlocks = 3;             // block_of() walks three
constexpr int kMaxRows = 192;             // sum of p_b
constexpr int kMaxQ = 64;
constexpr int kMaxChunk = 16;             // output rows per grid z
constexpr int kRingBytes = kStages * kThreads * kPer * 8;

struct Problem {
  const float2* b[kMaxBlocks];          // row 0 of lane 0 of each block
  long long b_ls[kMaxBlocks], b_rs[kMaxBlocks];            // in complex
  const float2* c[kMaxBlocks];
  long long c_ls[kMaxBlocks], c_rs[kMaxBlocks], c_cs[kMaxBlocks];
  int p[kMaxBlocks];
  int nb;
  const float2* a;                      // addend or null
  long long a_ls, a_rs;
  const float* s;                       // the addend rows' scale, or null
  long long s_ls, s_rs;
  float2* out;                          // (L, q, D) contiguous
  float sign;                           // -1 with `sub`
  int rows, q;                          // rows = sum of p_b
  long long D;
};

template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? kBytes : 0;  // src-size 0: zeros, nothing is read
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// acc += c * v, four real FMAs
__device__ __forceinline__ void cmac(float2& acc, float cr, float ci,
                                     float2 v) {
  acc.x = fmaf(cr, v.x, acc.x);
  acc.x = fmaf(-ci, v.y, acc.x);
  acc.y = fmaf(cr, v.y, acc.y);
  acc.y = fmaf(ci, v.x, acc.y);
}

// The block of stacked row r and the row's index in it, from the rows p0,
// p1 of the first two of nb blocks (the parameters are never indexed at
// run time).
__device__ __forceinline__ int block_of(int p0, int p1, int nb, int r,
                                        int& rb) {
  rb = r;
  if (nb > 1 && rb >= p0) {
    rb -= p0;
    if (nb > 2 && rb >= p1) {
      rb -= p1;
      return 2;
    }
    return 1;
  }
  return 0;
}

template <int Q, bool kVec, bool kScale>
__global__ void __launch_bounds__(kThreads, 3)
block_combine_kernel(const Problem pr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* coef = reinterpret_cast<float2*>(smem);            // [rows][Q]
  float* ring = reinterpret_cast<float*>(coef + pr.rows * Q);
  const float2** src =                                       // [steps]
      reinterpret_cast<const float2**>(ring + kRingBytes / 4);
  // the chunk's addend scales, after the steps' pointers (kScale)
  float* scl = reinterpret_cast<float*>(src + pr.rows + Q);
  const int tid = threadIdx.x;
  const int lane = blockIdx.y;
  const int j0 = blockIdx.z * Q;
  const int qn = min(Q, pr.q - j0);
  const int steps = pr.rows + (pr.a != nullptr ? qn : 0);

  // This lane's coefficients of the chunk's columns (zero past q), and the
  // first element of each row a tile step reads: the blocks' rows, then
  // the addend's.
  for (int i = tid; i < pr.rows * Q; i += kThreads) {
    const int r = i / Q, j = i % Q;
    int rb;
    const int b = block_of(pr.p[0], pr.p[1], pr.nb, r, rb);
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxBlocks; ++k)
      if (b == k && j < qn) {
        v = pr.c[k][lane * pr.c_ls[k] + rb * pr.c_rs[k] +
                    (long long)(j0 + j) * pr.c_cs[k]];
      }
    coef[i] = make_float2(pr.sign * v.x, pr.sign * v.y);
  }
  for (int r = tid; r < steps; r += kThreads) {
    const float2* p = nullptr;
    if (r < pr.rows) {
      int rb;
      const int b = block_of(pr.p[0], pr.p[1], pr.nb, r, rb);
#pragma unroll
      for (int k = 0; k < kMaxBlocks; ++k)
        if (b == k) p = pr.b[k] + lane * pr.b_ls[k] + rb * pr.b_rs[k];
    } else {
      p = pr.a + lane * pr.a_ls + (long long)(j0 + r - pr.rows) * pr.a_rs;
    }
    src[r] = p;
  }
  if (kScale)
    for (int j = tid; j < qn; j += kThreads)
      scl[j] = pr.s[lane * pr.s_ls + (long long)(j0 + j) * pr.s_rs];
  __syncthreads();

  // the lambdas below capture these copies, never the parameter struct
  const long long D = pr.D;
  const int q = pr.q, rows = pr.rows;
  const bool addend = pr.a != nullptr;
  float2* const out = pr.out;
  const long long ntiles = (D + kTile - 1) / kTile;
  // Load cursor: tile lt, step ls, kStages - 1 steps ahead of the compute.
  long long lt = blockIdx.x;
  int ls = 0;
  auto load = [&](int slot) {
    if (lt < ntiles) {
      const long long e0 = lt * kTile;
      const float2* row = src[ls] + e0;
      if (kVec) {
        float4* dst = reinterpret_cast<float4*>(ring) + slot * 2 * kThreads;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * (h * kThreads + tid);
          const bool ok = e0 + e < D;  // D even: both columns or none
          copy_async<16>(dst + h * kThreads + tid, ok ? row + e : src[ls],
                         ok);
        }
      } else {
        float2* dst = reinterpret_cast<float2*>(ring) + slot * 4 * kThreads;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = k * kThreads + tid;
          const bool ok = e0 + e < D;
          copy_async<8>(dst + k * kThreads + tid, ok ? row + e : src[ls], ok);
        }
      }
      if (++ls == steps) {
        ls = 0;
        lt += gridDim.x;
      }
    }
    commit();  // one group per step, empty past the last tile
  };

  int slot = 0;
  // Wait for the oldest step's copies, refill the slot consumed one step
  // ago, read this thread's 4 columns of the step's row.
  auto step = [&](float2 (&v)[kPer]) {
    wait_pending<kStages - 2>();
    load(slot == 0 ? kStages - 1 : slot - 1);
    if (kVec) {
      const float4* r4 = reinterpret_cast<const float4*>(ring) +
                         slot * 2 * kThreads + tid;
      const float4 x0 = r4[0], x1 = r4[kThreads];
      v[0] = make_float2(x0.x, x0.y);
      v[1] = make_float2(x0.z, x0.w);
      v[2] = make_float2(x1.x, x1.y);
      v[3] = make_float2(x1.z, x1.w);
    } else {
      const float2* r2 = reinterpret_cast<const float2*>(ring) +
                         slot * 4 * kThreads + tid;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = r2[k * kThreads];
    }
    if (++slot == kStages) slot = 0;
  };

  float2 acc[Q][kPer];
  auto store = [&](float2* dst, long long t) {
    const long long e0 = t * kTile;
    float2* base = dst + ((long long)lane * q + j0) * D + e0;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (j < qn) {
        float2* row = base + (long long)j * D;
        if (kVec) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * (h * kThreads + tid);
            if (e0 + e < D)
              *reinterpret_cast<float4*>(row + e) =
                  make_float4(acc[j][2 * h].x, acc[j][2 * h].y,
                              acc[j][2 * h + 1].x, acc[j][2 * h + 1].y);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = k * kThreads + tid;
            if (e0 + e < D) row[e] = acc[j][k];
          }
        }
      }
    }
  };

  // At most kStages - 1 groups pending when a step begins (its wait leaves
  // kStages - 2 and it commits one).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s);

  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
#pragma unroll
    for (int j = 0; j < Q; ++j)
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[j][e] = make_float2(0.f, 0.f);
    for (int r = 0; r < rows; ++r) {
      float2 v[kPer];
      step(v);
      const float4* cr = reinterpret_cast<const float4*>(coef + r * Q);
#pragma unroll
      for (int jj = 0; jj < Q / 2; ++jj) {
        const float4 c = cr[jj];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          cmac(acc[2 * jj][e], c.x, c.y, v[e]);
          cmac(acc[2 * jj + 1][e], c.z, c.w, v[e]);
        }
      }
    }
    if (addend) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j < qn) {
          float2 v[kPer];
          step(v);
          if (kScale) {
            const float sj = scl[j];
#pragma unroll
            for (int e = 0; e < kPer; ++e) {
              acc[j][e].x += __fmul_rn(v[e].x, sj);
              acc[j][e].y += __fmul_rn(v[e].y, sj);
            }
          } else {
#pragma unroll
            for (int e = 0; e < kPer; ++e) {
              acc[j][e].x += v[e].x;
              acc[j][e].y += v[e].y;
            }
          }
        }
      }
    }
    store(out, t);
  }
  wait_pending<0>();
}

// A scaled instance (always with an addend) keeps the chunk's scales
// after the steps' pointers.
constexpr size_t smem_bytes(int rows, int q_chunk, bool addend,
                            bool scale) {
  return (size_t)rows * q_chunk * 8 + kRingBytes +
         (size_t)(rows + (addend ? q_chunk : 0)) * 8 +
         (scale ? (size_t)q_chunk * 4 : 0);
}

// Every launch fits the 48 KB of dynamic shared memory a kernel gets
// without opting in (42.7 KB at 192 rows, 16 outputs and a scaled addend).
static_assert(smem_bytes(kMaxRows, kMaxChunk, true, true) <= 48 * 1024,
              "K4's shared memory exceeds 48 KB");

template <int Q, bool kVec, bool kScale>
int launch(const Problem& pr, int lanes, cudaStream_t st) {
  auto kernel = block_combine_kernel<Q, kVec, kScale>;
  const int nq = (pr.q + Q - 1) / Q;
  const size_t smem = smem_bytes(pr.rows, Q, pr.a != nullptr, kScale);
  // The resident blocks of the last (device, shared memory) this thread
  // launched with: the occupancy query costs more host time than the rest
  // of a launch, and the solvers repeat a few shapes.
  thread_local int last_dev = -1, last_smem = -1, last_slots = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || (int)smem != last_smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = (int)smem;
    last_slots = sms * per_sm;
  }
  const long long ntiles = (pr.D + kTile - 1) / kTile;
  long long slots = (long long)last_slots / ((long long)lanes * nq);
  if (slots < 1) slots = 1;
  // as many tiles for every block: no block walks one tile more at the end
  const long long per = (ntiles + slots - 1) / slots;
  const long long grid = (ntiles + per - 1) / per;
  kernel<<<dim3((unsigned)grid, lanes, nq), kThreads, smem, st>>>(pr);
  return (int)cudaGetLastError();
}

template <bool kVec, bool kScale>
int dispatch(const Problem& pr, int lanes, cudaStream_t st) {
  if (pr.q <= 4) return launch<4, kVec, kScale>(pr, lanes, st);
  if (pr.q <= 8) return launch<8, kVec, kScale>(pr, lanes, st);
  return launch<kMaxChunk, kVec, kScale>(pr, lanes, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// ptrs: b0, b1, b2, c0, c1, c2, a, out, s (null where absent; s, the
// addend rows' float32 scale, only with a).
// meta: nb, lanes, q, D, sub, then per block b (three of each, unused ones
// ignored) p_b; the blocks' lane and row strides b_ls, b_rs; the
// coefficients' lane, row and column strides c_ls, c_rs, c_cs; the
// addend's lane and row strides; then the scale's -- 5 + 3 + 6 + 9 + 2 + 2
// = 27 values, strides in elements.  out is contiguous (L, q, D).
// Launches on `stream` and returns the cudaError_t (0 on success).
extern "C" int pcx_block_combine(const void* const* ptrs,
                                 const long long* meta, void* stream) {
  Problem pr;
  pr.nb = (int)meta[0];
  const long long lanes = meta[1];
  pr.q = (int)meta[2];
  pr.D = meta[3];
  pr.sign = meta[4] ? -1.f : 1.f;
  if (pr.nb < 1 || pr.nb > kMaxBlocks || lanes < 1 || lanes > 65535 ||
      pr.q < 1 || pr.q > kMaxQ || pr.D < 1)
    return (int)cudaErrorInvalidValue;
  pr.rows = 0;
  bool vec = pr.D % 2 == 0;
  for (int k = 0; k < kMaxBlocks; ++k) {
    const bool on = k < pr.nb;
    pr.b[k] = on ? (const float2*)ptrs[k] : nullptr;
    pr.c[k] = on ? (const float2*)ptrs[3 + k] : nullptr;
    pr.p[k] = on ? (int)meta[5 + k] : 0;
    pr.b_ls[k] = meta[8 + 2 * k];
    pr.b_rs[k] = meta[9 + 2 * k];
    pr.c_ls[k] = meta[14 + 3 * k];
    pr.c_rs[k] = meta[15 + 3 * k];
    pr.c_cs[k] = meta[16 + 3 * k];
    if (!on) continue;
    if (pr.p[k] < 1 || pr.b[k] == nullptr || pr.c[k] == nullptr)
      return (int)cudaErrorInvalidValue;
    pr.rows += pr.p[k];
    vec = vec && aligned16(pr.b[k]) && pr.b_ls[k] % 2 == 0 &&
          pr.b_rs[k] % 2 == 0;
  }
  pr.a = (const float2*)ptrs[6];
  pr.a_ls = meta[23];
  pr.a_rs = meta[24];
  pr.out = (float2*)ptrs[7];
  pr.s = (const float*)ptrs[8];
  pr.s_ls = meta[25];
  pr.s_rs = meta[26];
  if (pr.rows > kMaxRows || pr.out == nullptr ||
      (pr.s != nullptr && pr.a == nullptr))
    return (int)cudaErrorInvalidValue;
  if (pr.a != nullptr)
    vec = vec && aligned16(pr.a) && pr.a_ls % 2 == 0 && pr.a_rs % 2 == 0;
  vec = vec && aligned16(pr.out);
  cudaStream_t st = (cudaStream_t)stream;
  if (pr.s != nullptr)
    return vec ? dispatch<true, true>(pr, (int)lanes, st)
               : dispatch<false, true>(pr, (int)lanes, st);
  return vec ? dispatch<true, false>(pr, (int)lanes, st)
             : dispatch<false, false>(pr, (int)lanes, st);
}
