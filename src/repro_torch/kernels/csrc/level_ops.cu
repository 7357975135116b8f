// The paper's per-level operations for NVIDIA Hopper (sm_90a): the offline
// phase's precomputed columns and the online phase one query, one level
// at a time.  Five kernels in two bodies:
//
//   segment reduction (segment_kernel<BODY, T>), one pass over (B, n) rows
//     PAA    : segment means (B, n) -> (B, N).
//              Replaces src/repro/kernels/paa.py::paa_pallas.
//     LINFIT : Σ_seg max(Σy² − L·mean·mean − Σxy²/Sxx, 0) (B, n) -> (B,),
//              the squared residual to the optimal per-segment line
//              (paper eq. 6's d(u,ū)²).
//              Replaces src/repro/kernels/linfit.py::
//              linfit_residual_sq_pallas.
//     SQDIST : Σ(x − q)² against one query (B, n) × (n,) -> (B,), the
//              final verification scan of SAX and FAST_SAX.
//              Replaces src/repro/kernels/sqdist.py::sqdist_pallas.
//   word gather (word_kernel<PRUNE>), one thread per (row, segment) cell
//     MINDIST: (n/N)·Σᵢ tq[wᵢ, i]² of (B, N) words against one query's
//              (α, N) panel tq[a, i] = tab[a, q_i] -> (B,).
//              Replaces src/repro/kernels/mindist.py::mindist_sq_pallas.
//     PRUNE  : alive ∧ |res − qres| ≤ ε ∧ MINDIST² ≤ ε·ε -> (B,) bool, one
//              cascade level (C9, then C10, eq. 9-10).
//              Replaces src/repro/kernels/fused_prune.py::
//              fused_prune_level_pallas.
//
// Design.
//   * Bit-identical to the plain versions (kernels/ref.py), which are the
//     engine's own device expressions (core/paa.paa, core/polyfit.
//     linfit_residual_sq): every sum runs in core/paa.row_sum's fixed
//     order — element i adds element i + h, h = ⌊w/2⌋, an odd tail moves
//     to the end, until one is left — and every product, sum and
//     difference is rounded on its own (__fmul_rn / __fadd_rn /
//     __fsub_rn: no contraction to an FMA).  PyTorch's CUDA division of a
//     tensor by a Python scalar multiplies by the f32 reciprocal, so
//     `/ L` and `/ Sxx` are multiplications by 1.0f / L and 1.0f / Sxx,
//     computed on the host.  So kernel 9's means discretize to the
//     engine's words and kernel 8's residuals are the engine's, bit for
//     bit, at breakpoints too.
//   * A block stages a tile of rows (the words of a tile of rows) in
//     shared memory with 16-byte loads, upcasting bf16 in the loader,
//     computes the elementwise prologue (y, y², y·xc; (x − q)²; the gathered
//     cell²), then all its threads reduce every slice of the tile in
//     row_sum's order together, one halving step at a time, in place.
//     Ragged B is masked: a block stages and reduces only its rows < B.
//   * C10 by gather from the panel staged transposed ([segment][symbol]),
//     not an α-way compare-select sweep (that exists in the Pallas
//     kernels only because a TPU has no gather).
//   * ε·ε is taken in f32, as the reference does; a PAD_RESIDUAL = 1e30
//     row dies in C9 at any finite ε.
//
// What bounds it on an H100 SXM (3.35 TB/s): every body reads each input
// byte once and does a few f32 operations per byte, far below the card's
// ridge point, so bytes bound all five.  At B = 2^20, n = 128: kernels 8
// and 11 read 536.9 MB (0.16 ms), kernel 9 at N = 16 also writes 67 MB
// (0.18 ms), kernel 10 at N = 16 reads 67 MB of words (0.02 ms), kernel 12
// 71 MB (0.02 ms).  The halving steps each end in __syncthreads, and the
// tiles are staged synchronously (no TMA, no double buffer): a first
// version, times in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int SEG_BUDGET = 48 * 1024;   // bytes: 4 blocks per SM
constexpr int SEG_ROWS_MAX = 64;
constexpr int WORD_CELLS = 8192;        // cells per word tile (32 KB)
constexpr int WORD_ROWS_MAX = 256;
constexpr int SMEM_LIMIT = 232448;      // 227 KB
constexpr int MAX_ALPHABET = 20;

enum Body { PAA = 0, LINFIT = 1, SQDIST = 2 };
enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Calls f(e, src[e]) for e in [0, count) over the block's threads, with
// 16-byte loads when src is 16-byte aligned.
template <typename T, typename F>
__device__ __forceinline__ void stage(const T* src, int count, F f) {
  constexpr int V = 16 / sizeof(T);
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = count / V;
    for (int v = threadIdx.x; v < nv; v += NTHREADS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (long)v * V);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) f(v * V + j, vals[j]);
    }
    head = nv * V;
  }
  for (int e = head + threadIdx.x; e < count; e += NTHREADS) f(e, src[e]);
}

// core/paa.row_sum of `slices` slices of width w at stride `stride` in
// shared memory, in place, for NB buffers at once; slice s's sum ends at
// b[s * stride].  Every thread of the block must call it.
template <int NB>
__device__ void row_sum_slices(float* b0, float* b1, float* b2, int slices,
                               int stride, int w) {
  while (w > 1) {
    const int h = w >> 1;
    const int total = slices * h;
    for (int e = threadIdx.x; e < total; e += NTHREADS) {
      const int s = e / h;
      const int o = s * stride + (e - s * h);
      b0[o] = __fadd_rn(b0[o], b0[o + h]);
      if constexpr (NB > 1) b1[o] = __fadd_rn(b1[o], b1[o + h]);
      if constexpr (NB > 2) b2[o] = __fadd_rn(b2[o], b2[o + h]);
    }
    __syncthreads();
    if (w & 1) {
      for (int s = threadIdx.x; s < slices; s += NTHREADS) {
        const int o = s * stride + h;
        b0[o] = b0[o + h];
        if constexpr (NB > 1) b1[o] = b1[o + h];
        if constexpr (NB > 2) b2[o] = b2[o + h];
      }
      __syncthreads();
    }
    w = h + (w & 1);
  }
}

struct SegParams {
  const void* x;      // (B, n) f32 or bf16
  const void* q;      // (n,) f32 or bf16 (SQDIST)
  int q_bf16;
  int B, n, N, L, rows;
  float inv_L, inv_sxx;
  float* out;         // (B, N) PAA, else (B,)
};

__host__ __device__ inline int seg_tile_floats(int body, int n, int N,
                                               int rows) {
  if (body == LINFIT) return 3 * rows * n + rows * N;
  if (body == SQDIST) return rows * n + n;
  return rows * n;
}

template <int BODY, typename T>
__global__ void __launch_bounds__(NTHREADS) segment_kernel(SegParams p) {
  extern __shared__ float sm[];
  const long row0 = (long)blockIdx.x * p.rows;
  const int rows = (int)(p.B - row0 < p.rows ? p.B - row0 : p.rows);
  const int n = p.n, N = p.N, L = p.L;
  const int tile = p.rows * n;
  float* b0 = sm;
  float* b1 = sm + tile;
  float* b2 = sm + 2 * tile;
  const T* src = static_cast<const T*>(p.x) + row0 * n;

  if constexpr (BODY == LINFIT) {
    if (L == 1) {                          // an exact fit: 0, as polyfit
      for (int r = threadIdx.x; r < rows; r += NTHREADS)
        p.out[row0 + r] = 0.f;
      return;
    }
  }
  if constexpr (BODY == SQDIST) {
    float* qs = sm + tile;
    for (int j = threadIdx.x; j < n; j += NTHREADS)
      qs[j] = p.q_bf16
                  ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[j])
                  : static_cast<const float*>(p.q)[j];
    __syncthreads();
    stage(src, rows * n, [&](int e, T raw) {
      const float d = __fsub_rn(to_f32(raw), qs[e % n]);
      b0[e] = __fmul_rn(d, d);
    });
    __syncthreads();
    row_sum_slices<1>(b0, nullptr, nullptr, rows, n, n);
    for (int r = threadIdx.x; r < rows; r += NTHREADS)
      p.out[row0 + r] = b0[r * n];
    return;
  }

  stage(src, rows * n, [&](int e, T raw) {
    const float y = to_f32(raw);
    b0[e] = y;
    if (BODY == LINFIT) {
      // The centred abscissa l − (L−1)/2, a half-integer, exact in f32.
      const int l = e % L;
      const float xc = __fmul_rn((float)(2 * l - (L - 1)), 0.5f);
      b1[e] = __fmul_rn(y, y);
      b2[e] = __fmul_rn(y, xc);
    }
  });
  __syncthreads();
  row_sum_slices<BODY == LINFIT ? 3 : 1>(b0, b1, b2, rows * N, L, L);

  if (BODY == PAA) {
    for (int e = threadIdx.x; e < rows * N; e += NTHREADS)
      p.out[row0 * N + e] = __fmul_rn(b0[e * L], p.inv_L);
    return;
  }
  // LINFIT: each segment's closed form, then the segments' row_sum.
  float* seg = sm + 3 * tile;
  for (int e = threadIdx.x; e < rows * N; e += NTHREADS) {
    const float sum_y = b0[e * L], sum_y2 = b1[e * L], sxy = b2[e * L];
    const float mean = __fmul_rn(sum_y, p.inv_L);
    const float a = __fsub_rn(sum_y2, __fmul_rn(__fmul_rn((float)L, mean),
                                                mean));
    const float b = __fmul_rn(__fmul_rn(sxy, sxy), p.inv_sxx);
    seg[e] = fmaxf(__fsub_rn(a, b), 0.f);
  }
  __syncthreads();
  row_sum_slices<1>(seg, nullptr, nullptr, rows, N, N);
  for (int r = threadIdx.x; r < rows; r += NTHREADS)
    p.out[row0 + r] = seg[r * N];
}

struct WordParams {
  const int* words;            // (B, N) int32 in [0, alphabet)
  const float* tq;             // (alphabet, N) panel of one query
  int B, N, alphabet, rows;
  float scale;                 // n / N
  const unsigned char* alive;  // PRUNE: (B,) bool
  const float* res;            // PRUNE: (B,) f32
  float qres, eps, eps2;
  void* out;                   // (B,) f32 MINDIST², or (B,) bool
};

__host__ __device__ inline int word_panel_floats(int N, int alphabet) {
  return (N * alphabet + 3) / 4 * 4;
}

template <bool PRUNE>
__global__ void __launch_bounds__(NTHREADS) word_kernel(WordParams p) {
  extern __shared__ float sm[];
  const int N = p.N, A = p.alphabet;
  float* panel = sm;                               // [segment][symbol]
  float* cells = sm + word_panel_floats(N, A);
  for (int e = threadIdx.x; e < N * A; e += NTHREADS) {
    const int a = e / N;
    panel[(e - a * N) * A + a] = p.tq[e];
  }
  __syncthreads();
  const long row0 = (long)blockIdx.x * p.rows;
  const int rows = (int)(p.B - row0 < p.rows ? p.B - row0 : p.rows);
  stage(p.words + row0 * N, rows * N, [&](int e, int w) {
    const float c = panel[(e % N) * A + w];
    cells[e] = __fmul_rn(c, c);
  });
  __syncthreads();
  row_sum_slices<1>(cells, nullptr, nullptr, rows, N, N);
  for (int r = threadIdx.x; r < rows; r += NTHREADS) {
    const long row = row0 + r;
    const float md2 = __fmul_rn(p.scale, cells[r * N]);
    if (PRUNE) {
      const bool keep = p.alive[row] != 0 &&
                        fabsf(__fsub_rn(p.res[row], p.qres)) <= p.eps &&
                        md2 <= p.eps2;
      static_cast<unsigned char*>(p.out)[row] = keep ? 1 : 0;
    } else {
      static_cast<float*>(p.out)[row] = md2;
    }
  }
}

int seg_rows(int body, int n, int N) {
  const int per_row = body == LINFIT ? 3 * n + N : n;
  const int fixed = body == SQDIST ? n : 0;
  int rows = (SEG_BUDGET / 4 - fixed) / per_row;
  if (rows > SEG_ROWS_MAX) rows = SEG_ROWS_MAX;
  return rows < 1 ? 1 : rows;
}

int word_rows(int N) {
  int rows = WORD_CELLS / N;
  if (rows > WORD_ROWS_MAX) rows = WORD_ROWS_MAX;
  return rows < 1 ? 1 : rows;
}

template <typename K, typename P>
int launch(K kernel, const P& p, int blocks, int smem, cudaStream_t s) {
  if (smem > SMEM_LIMIT) return -5;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, NTHREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int BODY>
int launch_seg(const SegParams& p, int dtype, int smem, cudaStream_t s) {
  const int blocks = (p.B + p.rows - 1) / p.rows;
  if (dtype == BF16)
    return launch(segment_kernel<BODY, __nv_bfloat16>, p, blocks, smem, s);
  return launch(segment_kernel<BODY, float>, p, blocks, smem, s);
}

}  // namespace

extern "C" {

// Error codes below 0 are argument errors; above 0, a cudaError_t.
const char* level_ops_error(int code) {
  switch (code) {
    case -1: return "body must be 0 (paa), 1 (linfit) or 2 (sqdist)";
    case -2: return "dtype must be 0 (f32) or 1 (bf16)";
    case -3: return "need B >= 1 and 1 <= N <= n with N dividing n";
    case -4: return "alphabet must be between 2 and 20";
    case -5: return "the tile's shared memory exceeds 227 KB";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "ok";
  }
}

// Rows per thread block and bytes of dynamic shared memory of a launch:
// kind 0-2 the segment bodies (paa, linfit, sqdist) over rows of length
// n with N segments, kind 3 the word gather over N-symbol words.
int level_ops_tile(int kind, int n, int N, int alphabet, int* smem) {
  if (kind == 3) {
    const int rows = word_rows(N);
    *smem = 4 * (word_panel_floats(N, alphabet) + rows * N);
    return rows;
  }
  const int rows = seg_rows(kind, n, N);
  *smem = 4 * seg_tile_floats(kind, n, N, rows);
  return rows;
}

// Kernels 8, 9 and 11 over (B, n) rows x (f32 or bf16, contiguous):
// body 0 writes (B, N) means, 1 (B,) squared residuals, 2 (B,) squared
// distances to q ((n,), f32 or bf16 by q_dtype).  Device pointers;
// nothing is allocated and nothing synchronises.
int level_segment_launch(int body, int dtype, const void* x, int B, int n,
                         int N, const void* q, int q_dtype, float* out,
                         void* stream) {
  if (body < PAA || body > SQDIST) return -1;
  if (dtype != F32 && dtype != BF16) return -2;
  if (body == SQDIST) N = 1;
  if (B < 1 || n < 1 || N < 1 || N > n || n % N) return -3;
  SegParams p{};
  p.x = x; p.q = q; p.q_bf16 = q_dtype == BF16;
  p.B = B; p.n = n; p.N = N; p.L = n / N;
  p.rows = seg_rows(body, n, N);
  p.inv_L = 1.0f / (float)p.L;
  const double sxx = (double)p.L * ((double)p.L * p.L - 1.0) / 12.0;
  p.inv_sxx = p.L > 1 ? 1.0f / (float)sxx : 0.f;
  p.out = out;
  const int smem = 4 * seg_tile_floats(body, n, N, p.rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == PAA) return launch_seg<PAA>(p, dtype, smem, s);
  if (body == LINFIT) return launch_seg<LINFIT>(p, dtype, smem, s);
  return launch_seg<SQDIST>(p, dtype, smem, s);
}

// Kernels 10 (prune = 0: (B,) f32 MINDIST² into out) and 12 (prune = 1:
// (B,) bool alive' into out from alive, res, qres, eps and eps2 = ε·ε in
// f32) over (B, N) int32 words and one query's (alphabet, N) panel tq.
int level_word_launch(int prune, const int* words, int B, int N,
                      int alphabet, const float* tq, float scale,
                      const unsigned char* alive, const float* res,
                      float qres, float eps, float eps2, void* out,
                      void* stream) {
  if (B < 1 || N < 1) return -3;
  if (alphabet < 2 || alphabet > MAX_ALPHABET) return -4;
  WordParams p{};
  p.words = words; p.tq = tq; p.B = B; p.N = N; p.alphabet = alphabet;
  p.rows = word_rows(N);
  p.scale = scale;
  p.alive = alive; p.res = res; p.qres = qres; p.eps = eps; p.eps2 = eps2;
  p.out = out;
  const int smem = 4 * (word_panel_floats(N, alphabet) + p.rows * N);
  const int blocks = (B + p.rows - 1) / p.rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prune) return launch(word_kernel<true>, p, blocks, smem, s);
  return launch(word_kernel<false>, p, blocks, smem, s);
}

}  // extern "C"
