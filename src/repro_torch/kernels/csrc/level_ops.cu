// The paper's per-level operations for NVIDIA Hopper (sm_90a): the offline
// phase's precomputed columns and the online phase one query, one level
// at a time.  Five kernels in four bodies:
//
//   segment reduction (segment_kernel<BODY, T>), one pass over (B, n) rows
//     PAA    : segment means (B, n) -> (B, N).
//              Replaces src/repro/kernels/paa.py::paa_pallas.
//   row distance (sqdist_kernel<n, T>, else segment_kernel<SQDIST, T>)
//     SQDIST : Σ(x − q)² against one query (B, n) × (n,) -> (B,), the
//              final verification scan of SAX and FAST_SAX.
//              Replaces src/repro/kernels/sqdist.py::sqdist_pallas.
//   linear fit (linfit_kernel<L, T>, else linfit_generic_kernel<T>)
//     LINFIT : Σ_seg max(Σy² − L·mean·mean − Σxy²/Sxx, 0) (B, n) -> (B,),
//              the squared residual to the optimal per-segment line
//              (paper eq. 6's d(u,ū)²).
//              Replaces src/repro/kernels/linfit.py::
//              linfit_residual_sq_pallas.
//   word gather (word_kernel<N, PRUNE>, else word_generic_kernel)
//     MINDIST: (n/N)·Σᵢ tab[wᵢ, qᵢ]² of (B, N) words against one query
//              word -> (B,).
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
//   * PAA: a block stages a tile of rows in shared memory with 16-byte
//     loads, upcasting bf16 in the loader, and all its threads halve every
//     slice of the tile in row_sum's order together, one barriered step at
//     a time.  Ragged B is masked.
//   * SQDIST keeps each row in registers, not in a block's shared tile: a
//     row of n = 2^k ≤ 1024 elements lies in G = min(n, 32) lanes, lane j
//     holding elements j, j + G, j + 2G, … (V = n / G of them, each read
//     alone: a warp's load is one contiguous run, and any row start is
//     aligned for it).  row_sum's steps h ≥ G pair two values of one lane
//     (tree_sum<V>), the last log2 G are shuffles (lane j adds lane
//     j + h).  A warp loads the query (V registers a lane) and R·(32 / G)
//     consecutive rows, 16 values a lane, all at once: a small B (the
//     survivors of a level-at-a-time query) still fills the card with
//     warps whose loads are all in flight.  Each row's sum goes to one
//     lane, so the output is written in one run a warp.  No shared
//     memory, no barrier.  Other n go through the segment body as PAA
//     does (the query staged beside the tile).
//   * LINFIT keeps each segment in registers: one thread per segment of L
//     elements (L a power of two up to 32), loaded with 16-byte vectors,
//     forms Σy, Σy² and Σy·xc in row_sum's order (tree_sum, unrolled) and
//     the closed form; a row's N ≤ 32 segments are neighbouring lanes of
//     one warp and are summed in row_sum's order with shuffles (an odd
//     tail is the lane at h).  No shared memory, no barrier.  Other
//     shapes (odd or long L, N > 32, rows not 16-byte aligned) go through
//     linfit_generic_kernel: one thread per row, each halving its own
//     slice of shared memory at an odd stride (no bank conflicts, no
//     barrier).
//   * The word bodies read the α × α MINDIST table (staged transposed in
//     shared memory once per block, the only barrier) through the query
//     word, which travels by value in the launch's parameters as 16-bit
//     offsets qᵢ·α: the cell tab[wᵢ, qᵢ] is tabT[qᵢ·α + wᵢ], the value the
//     per-query panel tq[wᵢ, i] held, bit for bit.  No per-query panel,
//     no host-to-device copy.  For N a power of two up to 128, V = min(N,
//     4) words of a row per lane in one 4·V-byte load and G = N/V lanes
//     per row: row_sum's halving steps above V are shuffles between the
//     lanes (lane j adds lane j + G/2, …, then j + 1), the last log2 V
//     inside the lane.  A warp takes 32 consecutive rows; each lane then
//     tests and writes one of them, so alive, res and the output are read
//     and written in runs of 32.  C9 is evaluated first and the words of
//     a row it (or the incoming mask) kills are not read: C10 cannot
//     change its result.  Other N (and unaligned words) go through
//     word_generic_kernel, one thread per row over its own slice.
//   * ε·ε is taken in f32, as the reference does; a PAD_RESIDUAL = 1e30
//     row dies in C9 at any finite ε.
//
// What bounds it on an H100 SXM (3.35 TB/s): every body reads each input
// byte once and does a few f32 operations per byte, far below the card's
// ridge point, so bytes bound all five.  At B = 2^20, n = 128: kernels 8
// and 11 read 536.9 MB (0.16 ms), kernel 9 at N = 16 also writes 67 MB
// (0.18 ms), kernel 10 at N = 16 reads 67 MB of words (0.02 ms), kernel 12
// at most 73 MB (0.02 ms; less where C9 kills rows); kernel 11 at the
// level-at-a-time query's ≈ 51,000 survivors reads 26 MB (8 µs), which
// fits in the 50 MB L2.  Times in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SEG_BUDGET = 48 * 1024;   // bytes: 4 blocks per SM
constexpr int SEG_ROWS_MAX = 64;
constexpr int SMEM_DEFAULT = 48 * 1024; // dynamic bytes without the opt-in
constexpr int SMEM_LIMIT = 232448;      // 227 KB
constexpr int MAX_ALPHABET = 20;
constexpr int TABLE_FLOATS = MAX_ALPHABET * MAX_ALPHABET;
// The query word travels in the launch's parameters, which every launch
// copies.  Words of up to QOFF_SHORT symbols (every fast width, the
// path's 8 and 16) use a 256-byte array; longer ones one of WORD_N_MAX
// symbols, 32,000 bytes, under the 32,764 bytes a launch may carry (CUDA
// 12.1 and later).  The
// shared-memory panel this replaced capped N·(α + 1) at 58,112 floats, so
// every N accepted before (at most 14,528, at α = 3) is accepted still.
constexpr int QOFF_SHORT = 128;
constexpr int WORD_N_MAX = 16000;
// Per-thread slices of the generic bodies: bytes a block holds.
constexpr int GENERIC_BUDGET = 48 * 1024;

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
// shared memory, in place, by the whole block; slice s's sum ends at
// b[s * stride].  Every thread of the block must call it.
__device__ void row_sum_slices(float* b, int slices, int stride, int w) {
  while (w > 1) {
    const int h = w >> 1;
    const int total = slices * h;
    for (int e = threadIdx.x; e < total; e += NTHREADS) {
      const int s = e / h;
      const int o = s * stride + (e - s * h);
      b[o] = __fadd_rn(b[o], b[o + h]);
    }
    __syncthreads();
    if (w & 1) {
      for (int s = threadIdx.x; s < slices; s += NTHREADS) {
        const int o = s * stride + h;
        b[o] = b[o + h];
      }
      __syncthreads();
    }
    w = h + (w & 1);
  }
}

// core/paa.row_sum of W values in registers, in place: the sum ends in
// v[0].  Unrolled at compile time, so v stays in registers.
template <int W>
__device__ __forceinline__ void tree_sum(float* v) {
  if constexpr (W > 1) {
    constexpr int h = W / 2;
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
    if constexpr ((W & 1) != 0) v[h] = v[2 * h];
    tree_sum<h + (W & 1)>(v);
  }
}

// core/paa.row_sum of a thread's own slice of w values, in place.  The
// generic bodies' slices lie at an odd stride, so the 32 lanes of a warp,
// at the same step of the same width, touch 32 different banks.
__device__ __forceinline__ float slice_sum(float* v, int w) {
  while (w > 1) {
    const int h = w >> 1;
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
    if (w & 1) v[h] = v[2 * h];
    w = h + (w & 1);
  }
  return v[0];
}

// ---------------------------------------------------------------------------
// PAA (and SQDIST's other widths): the block-cooperative segment body.
// ---------------------------------------------------------------------------

struct SegParams {
  const void* x;      // (B, n) f32 or bf16
  const void* q;      // (n,) f32 or bf16 (SQDIST)
  int q_bf16;
  int B, n, N, L, rows;
  float inv_L;
  float* out;         // (B, N) PAA, else (B,)
};

__host__ __device__ inline int seg_tile_floats(int body, int n, int rows) {
  return body == SQDIST ? rows * n + n : rows * n;
}

template <int BODY, typename T>
__global__ void __launch_bounds__(NTHREADS) segment_kernel(SegParams p) {
  extern __shared__ float sm[];
  const long row0 = (long)blockIdx.x * p.rows;
  const int rows = (int)(p.B - row0 < p.rows ? p.B - row0 : p.rows);
  const int n = p.n, N = p.N, L = p.L;
  float* b0 = sm;
  const T* src = static_cast<const T*>(p.x) + row0 * n;

  if constexpr (BODY == SQDIST) {
    float* qs = sm + p.rows * n;
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
    row_sum_slices(b0, rows, n, n);
    for (int r = threadIdx.x; r < rows; r += NTHREADS)
      p.out[row0 + r] = b0[r * n];
    return;
  }

  stage(src, rows * n, [&](int e, T raw) { b0[e] = to_f32(raw); });
  __syncthreads();
  row_sum_slices(b0, rows * N, L, L);
  for (int e = threadIdx.x; e < rows * N; e += NTHREADS)
    p.out[row0 * N + e] = __fmul_rn(b0[e * L], p.inv_L);
}

int seg_rows(int body, int n) {
  const int fixed = body == SQDIST ? n : 0;
  int rows = (SEG_BUDGET / 4 - fixed) / n;
  if (rows > SEG_ROWS_MAX) rows = SEG_ROWS_MAX;
  return rows < 1 ? 1 : rows;
}

// ---------------------------------------------------------------------------
// SQDIST: a row per G lanes, in registers.
// ---------------------------------------------------------------------------

// The widest row the register body holds: V = 32 values a lane.
constexpr int SQDIST_N_MAX = 1024;

bool sqdist_fast(int n) {
  return n >= 1 && n <= SQDIST_N_MAX && (n & (n - 1)) == 0;
}

// Steps R of sqdist_kernel<n>: a warp loads R·(32 / G) rows at once, 16
// values a lane (V per row), at least one row, at most a step per lane.
__host__ __device__ constexpr int sqdist_steps(int n) {
  return n < 32 ? n : (n >= 16 * 32 ? 1 : 16 * 32 / n);
}

// Rows a warp takes: R steps of 32 / G rows.
__host__ __device__ constexpr int sqdist_warp_rows(int n) {
  return n < 32 ? 32 : sqdist_steps(n);
}

template <int N, typename T>
__global__ void __launch_bounds__(NTHREADS) sqdist_kernel(SegParams p) {
  constexpr int G = N < 32 ? N : 32;  // lanes per row
  constexpr int V = N / G;            // elements per lane, at stride G
  constexpr int P = 32 / G;           // rows per step
  constexpr int R = sqdist_steps(N);  // steps, all loaded at once
  constexpr int ROWS = R * P;         // the warp's rows
  const int lane = threadIdx.x & 31;
  const int j = lane % G;             // the lane's place in its row
  const int k = lane / G;             // its row in a step
  const long row0 = ((long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  if (row0 >= p.B) return;
  const int rows = p.B - row0 < ROWS ? (int)(p.B - row0) : ROWS;
  // ---- loads: the query's V elements j + v·G, upcast, and those of rows
  // r·P + k, r < R
  float qv[V], e[R][V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    qv[v] = p.q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(p.q)[j + v * G])
                     : static_cast<const float*>(p.q)[j + v * G];
  const T* x = static_cast<const T*>(p.x) + (row0 + k) * N + j;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = r * P + k < rows;
#pragma unroll
    for (int v = 0; v < V; ++v)
      e[r][v] = in ? to_f32(x[r * P * N + v * G]) : 0.f;
  }
  // ---- squares and the in-lane tree: row_sum's steps h ≥ G
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = __fsub_rn(e[r][v], qv[v]);
      e[r][v] = __fmul_rn(d, d);
    }
    tree_sum<V>(e[r]);
  }
  // ---- shuffles: row_sum's steps h < G, lane j adds lane j + h
  float d2 = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = G / 2; h >= 1; h >>= 1)
      e[r][0] = __fadd_rn(e[r][0], __shfl_down_sync(FULL, e[r][0], h));
    // Row r·P + k's sum is in lane k·G; lane r·P + k takes it.
    const float t = __shfl_sync(FULL, e[r][0], (lane % P) * G);
    if (lane / P == r) d2 = t;
  }
  // ---- write: the warp's rows, one a lane
  if (lane < rows) p.out[row0 + lane] = d2;
}

// ---------------------------------------------------------------------------
// LINFIT: one segment per thread, in registers.
// ---------------------------------------------------------------------------

struct LinfitParams {
  const void* x;      // (B, n) f32 or bf16
  int B, n, N, L;
  int rows;           // rows per block (the generic body)
  float inv_L, inv_sxx;
  float* out;         // (B,)
};

// The L elements of one segment as f32, in 16-byte loads (8- and 4-byte
// ones for segments shorter than 16 bytes); src is aligned to that size.
template <int L, typename T>
__device__ __forceinline__ void load_segment(const T* src, float* y) {
  constexpr int BYTES = L * (int)sizeof(T);
  if constexpr (BYTES >= 16) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < L / V; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) y[c * V + j] = to_f32(vals[j]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < L; ++j) y[j] = to_f32(vals[j]);
  } else {
    static_assert(BYTES == 4, "a segment of at least 4 bytes");
    const unsigned raw = *reinterpret_cast<const unsigned*>(src);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < L; ++j) y[j] = to_f32(vals[j]);
  }
}

// The segment's residual² from its three sums (polyfit's closed form).
__device__ __forceinline__ float closed_form(float sum_y, float sum_y2,
                                             float sxy, float L, float inv_L,
                                             float inv_sxx) {
  const float mean = __fmul_rn(sum_y, inv_L);
  const float a = __fsub_rn(sum_y2, __fmul_rn(__fmul_rn(L, mean), mean));
  const float b = __fmul_rn(__fmul_rn(sxy, sxy), inv_sxx);
  return fmaxf(__fsub_rn(a, b), 0.f);
}

// A warp holds 32 / N rows, lane r·N + s on segment s of row r; lanes past
// the last whole row idle.
template <int L, typename T>
__global__ void __launch_bounds__(NTHREADS) linfit_kernel(LinfitParams p) {
  const int N = p.N;
  const int per_warp = 32 / N;
  const int lane = threadIdx.x & 31;
  const int r = lane / N, s = lane - r * N;
  const long row =
      ((long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * per_warp + r;
  const bool live = r < per_warp && row < p.B;
  float v = 0.f;
  if (live) {
    // ---- load: the segment's L elements
    float y[L], y2[L], yx[L];
    load_segment<L, T>(static_cast<const T*>(p.x) + row * p.n + s * L, y);
    // ---- segment sums: Σy, Σy² and Σy·xc, xc = l − (L−1)/2 (exact)
#pragma unroll
    for (int l = 0; l < L; ++l) {
      y2[l] = __fmul_rn(y[l], y[l]);
      yx[l] = __fmul_rn(y[l], (float)(2 * l - (L - 1)) * 0.5f);
    }
    tree_sum<L>(y);
    tree_sum<L>(y2);
    tree_sum<L>(yx);
    // ---- closed form
    v = closed_form(y[0], y2[0], yx[0], (float)L, p.inv_L, p.inv_sxx);
  }
  // ---- the row's segments: row_sum over lanes s of one row (s + h stays
  // inside the row; an odd width's tail, lane 2h, moves to lane h)
  for (int w = N; w > 1;) {
    const int h = w >> 1;
    const float o = __shfl_down_sync(FULL, v, h);
    if (s < h) v = __fadd_rn(v, o);
    else if (s == h && (w & 1)) v = o;
    w = h + (w & 1);
  }
  if (live && s == 0) p.out[row] = v;
}

// Odd shapes: one thread per row over its own slices (L elements, then
// the row's N segment values) of shared memory; one float for L = 1,
// which writes 0 and reads nothing.
__host__ __device__ inline int linfit_slice_floats(int L, int N) {
  return L == 1 ? 1 : ((L | 1) + (N | 1)) | 1;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    linfit_generic_kernel(LinfitParams p) {
  extern __shared__ float sm[];
  const long row = (long)blockIdx.x * p.rows + threadIdx.x;
  if ((int)threadIdx.x >= p.rows || row >= p.B) return;
  const int L = p.L, N = p.N;
  if (L == 1) {                            // an exact fit: 0, as polyfit
    p.out[row] = 0.f;
    return;
  }
  float* ys = sm + threadIdx.x * linfit_slice_floats(L, N);
  float* seg = ys + (L | 1);
  const T* src = static_cast<const T*>(p.x) + row * p.n;
  for (int s = 0; s < N; ++s, src += L) {
    for (int l = 0; l < L; ++l) ys[l] = to_f32(src[l]);
    const float sum_y = slice_sum(ys, L);
    for (int l = 0; l < L; ++l) {
      const float y = to_f32(src[l]);
      ys[l] = __fmul_rn(y, y);
    }
    const float sum_y2 = slice_sum(ys, L);
    for (int l = 0; l < L; ++l)
      ys[l] = __fmul_rn(to_f32(src[l]),
                        __fmul_rn((float)(2 * l - (L - 1)), 0.5f));
    const float sxy = slice_sum(ys, L);
    seg[s] = closed_form(sum_y, sum_y2, sxy, (float)L, p.inv_L, p.inv_sxx);
  }
  p.out[row] = slice_sum(seg, N);
}

// Rows per block of a generic body whose thread holds `floats` floats:
// as many as GENERIC_BUDGET holds, whole warps where there are 32.
int generic_rows(int floats) {
  int rows = GENERIC_BUDGET / (4 * floats);
  if (rows > NTHREADS) rows = NTHREADS;
  if (rows >= 32) rows -= rows % 32;
  return rows < 1 ? 1 : rows;
}

bool linfit_fast(int L, int N) {
  return (L == 2 || L == 4 || L == 8 || L == 16 || L == 32) && N <= 32;
}

// ---------------------------------------------------------------------------
// MINDIST and PRUNE: the word gather.
// ---------------------------------------------------------------------------

template <int CAP>
struct WordParams {
  const int* words;            // (B, N) int32 in [0, alphabet)
  const float* tab;            // (alphabet, alphabet) MINDIST table
  int B, N, alphabet;
  int rows;                    // rows per block (the generic body)
  float scale;                 // n / N
  const unsigned char* alive;  // PRUNE: (B,) bool
  const float* res;            // PRUNE: (B,) f32
  float qres, eps, eps2;
  void* out;                   // (B,) f32 MINDIST², or (B,) bool
  unsigned short qoff[CAP];    // the query word: q_i·α
};

// The table transposed into shared memory, tabT[c·α + r] = tab[r·α + c];
// the block's one barrier.
__device__ __forceinline__ void stage_table(const float* tab, int A,
                                            float* tabT) {
  for (int e = threadIdx.x; e < A * A; e += blockDim.x) {
    const int r = e / A;
    tabT[(e - r * A) * A + r] = tab[e];
  }
  __syncthreads();
}

// C9 and the incoming mask: does the row's C10 still matter?
template <bool PRUNE, typename P>
__device__ __forceinline__ bool needs_c10(const P& p, long row) {
  if (!PRUNE) return true;
  return p.alive[row] != 0 && fabsf(__fsub_rn(p.res[row], p.qres)) <= p.eps;
}

template <bool PRUNE, typename P>
__device__ __forceinline__ void write_row(const P& p, long row, bool need,
                                          float md2) {
  if (PRUNE)
    static_cast<unsigned char*>(p.out)[row] = need && md2 <= p.eps2 ? 1 : 0;
  else
    static_cast<float*>(p.out)[row] = md2;
}

template <int V>
__device__ __forceinline__ void load_words(const int* src, int* w) {
  if constexpr (V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(src);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (V == 2) {
    const int2 t = *reinterpret_cast<const int2*>(src);
    w[0] = t.x; w[1] = t.y;
  } else {
    w[0] = *src;
  }
}

template <int N, bool PRUNE>
__global__ void __launch_bounds__(NTHREADS)
    word_kernel(const __grid_constant__ WordParams<QOFF_SHORT> p) {
  __shared__ float tabT[TABLE_FLOATS];
  constexpr int V = N < 4 ? N : 4;   // words per lane, one load
  constexpr int G = N / V;           // lanes per row
  constexpr int P = 32 / G;          // rows per step; G steps take 32 rows
  stage_table(p.tab, p.alphabet, tabT);
  const int lane = threadIdx.x & 31;
  const int j = lane % G, k = lane / G;
  int off[V];
#pragma unroll
  for (int v = 0; v < V; ++v) off[v] = p.qoff[j * V + v];
  const long row0 = ((long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * 32;
  if (row0 >= p.B) return;
  // ---- C9: this lane's row of the warp's 32
  const long row = row0 + lane;
  const bool valid = row < p.B;
  const bool need = valid && needs_c10<PRUNE>(p, row);
  const unsigned mask = __ballot_sync(FULL, need);
  float md = 0.f;
  if (mask) {
#pragma unroll 8
    for (int st = 0; st < G; ++st) {
      const int rr = st * P + k;     // the row of the run this lane loads
      float c[V];
      if ((mask >> rr) & 1u) {
        // ---- load and gather: tab[w, q_i]², each rounded
        int w[V];
        load_words<V>(p.words + (row0 + rr) * N + j * V, w);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float t = tabT[off[v] + w[v]];
          c[v] = __fmul_rn(t, t);
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) c[v] = 0.f;
      }
      // ---- tree: row_sum's steps h ≥ V between lanes, then in the lane
#pragma unroll
      for (int hl = G / 2; hl >= 1; hl >>= 1) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          c[v] = __fadd_rn(c[v], __shfl_down_sync(FULL, c[v], hl));
      }
      tree_sum<V>(c);
      // Row st·P + k's sum is in lane k·G; lane st·P + k takes it.
      const float t = __shfl_sync(FULL, c[0], (lane % P) * G);
      if (lane / P == st) md = t;
    }
  }
  // ---- write
  if (valid) write_row<PRUNE>(p, row, need, __fmul_rn(p.scale, md));
}

// Other N, and words not aligned for the vector loads: one thread per row
// over its own slice of N cells.
template <int CAP, bool PRUNE>
__global__ void __launch_bounds__(NTHREADS)
    word_generic_kernel(const __grid_constant__ WordParams<CAP> p) {
  __shared__ float tabT[TABLE_FLOATS];
  extern __shared__ float sm[];
  stage_table(p.tab, p.alphabet, tabT);
  const long row = (long)blockIdx.x * p.rows + threadIdx.x;
  if ((int)threadIdx.x >= p.rows || row >= p.B) return;
  const bool need = needs_c10<PRUNE>(p, row);
  float md2 = 0.f;
  if (need) {
    const int N = p.N;
    float* cells = sm + threadIdx.x * (N | 1);
    const int* w = p.words + row * N;
    for (int i = 0; i < N; ++i) {
      const float t = tabT[p.qoff[i] + w[i]];
      cells[i] = __fmul_rn(t, t);
    }
    md2 = __fmul_rn(p.scale, slice_sum(cells, N));
  }
  write_row<PRUNE>(p, row, need, md2);
}

bool word_fast(int N) {
  return N <= QOFF_SHORT && (N & (N - 1)) == 0;
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <typename K, typename P>
int launch(K kernel, const P& p, int blocks, int threads, int smem,
           cudaStream_t s) {
  if (smem > SMEM_LIMIT) return -5;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int BODY>
int launch_seg(const SegParams& p, int dtype, int smem, cudaStream_t s) {
  const int blocks = (p.B + p.rows - 1) / p.rows;
  if (dtype == BF16)
    return launch(segment_kernel<BODY, __nv_bfloat16>, p, blocks, NTHREADS,
                  smem, s);
  return launch(segment_kernel<BODY, float>, p, blocks, NTHREADS, smem, s);
}

template <typename T>
int launch_sqdist(const SegParams& p, cudaStream_t s) {
  const int rows = WARPS * sqdist_warp_rows(p.n);
  const int blocks = (int)(((long)p.B + rows - 1) / rows);
  switch (p.n) {
    case 1: return launch(sqdist_kernel<1, T>, p, blocks, NTHREADS, 0, s);
    case 2: return launch(sqdist_kernel<2, T>, p, blocks, NTHREADS, 0, s);
    case 4: return launch(sqdist_kernel<4, T>, p, blocks, NTHREADS, 0, s);
    case 8: return launch(sqdist_kernel<8, T>, p, blocks, NTHREADS, 0, s);
    case 16: return launch(sqdist_kernel<16, T>, p, blocks, NTHREADS, 0, s);
    case 32: return launch(sqdist_kernel<32, T>, p, blocks, NTHREADS, 0, s);
    case 64: return launch(sqdist_kernel<64, T>, p, blocks, NTHREADS, 0, s);
    case 128: return launch(sqdist_kernel<128, T>, p, blocks, NTHREADS, 0, s);
    case 256: return launch(sqdist_kernel<256, T>, p, blocks, NTHREADS, 0, s);
    case 512: return launch(sqdist_kernel<512, T>, p, blocks, NTHREADS, 0, s);
    default:
      return launch(sqdist_kernel<1024, T>, p, blocks, NTHREADS, 0, s);
  }
}

template <typename T>
int launch_linfit(LinfitParams& p, bool aligned, cudaStream_t s) {
  if (aligned && linfit_fast(p.L, p.N)) {
    const int rows = WARPS * (32 / p.N);
    const int blocks = (int)(((long)p.B + rows - 1) / rows);
    switch (p.L) {
      case 2: return launch(linfit_kernel<2, T>, p, blocks, NTHREADS, 0, s);
      case 4: return launch(linfit_kernel<4, T>, p, blocks, NTHREADS, 0, s);
      case 8: return launch(linfit_kernel<8, T>, p, blocks, NTHREADS, 0, s);
      case 16: return launch(linfit_kernel<16, T>, p, blocks, NTHREADS, 0, s);
      default: return launch(linfit_kernel<32, T>, p, blocks, NTHREADS, 0, s);
    }
  }
  const int floats = linfit_slice_floats(p.L, p.N);
  p.rows = generic_rows(floats);
  const int blocks = (p.B + p.rows - 1) / p.rows;
  return launch(linfit_generic_kernel<T>, p, blocks, p.rows,
                4 * p.rows * floats, s);
}

template <bool PRUNE>
int launch_word_fast(const WordParams<QOFF_SHORT>& p, cudaStream_t s) {
  const int blocks = (p.B + NTHREADS - 1) / NTHREADS;  // 32 rows a warp
  switch (p.N) {
    case 1: return launch(word_kernel<1, PRUNE>, p, blocks, NTHREADS, 0, s);
    case 2: return launch(word_kernel<2, PRUNE>, p, blocks, NTHREADS, 0, s);
    case 4: return launch(word_kernel<4, PRUNE>, p, blocks, NTHREADS, 0, s);
    case 8: return launch(word_kernel<8, PRUNE>, p, blocks, NTHREADS, 0, s);
    case 16: return launch(word_kernel<16, PRUNE>, p, blocks, NTHREADS, 0, s);
    case 32: return launch(word_kernel<32, PRUNE>, p, blocks, NTHREADS, 0, s);
    case 64: return launch(word_kernel<64, PRUNE>, p, blocks, NTHREADS, 0, s);
    default:
      return launch(word_kernel<128, PRUNE>, p, blocks, NTHREADS, 0, s);
  }
}

template <int CAP>
int launch_word(int prune, const int* words, int B, int N, int alphabet,
                const float* tab, const unsigned short* qoff, float scale,
                const unsigned char* alive, const float* res, float qres,
                float eps, float eps2, void* out, cudaStream_t s) {
  WordParams<CAP> p;
  p.words = words; p.tab = tab;
  p.B = B; p.N = N; p.alphabet = alphabet;
  p.scale = scale;
  p.alive = alive; p.res = res; p.qres = qres; p.eps = eps; p.eps2 = eps2;
  p.out = out;
  for (int i = 0; i < N; ++i) p.qoff[i] = qoff[i];
  const int V = N < 4 ? N : 4;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(words) % (4 * V)) == 0;
  if constexpr (CAP == QOFF_SHORT) {
    if (aligned && word_fast(N)) {
      p.rows = NTHREADS;
      return prune ? launch_word_fast<true>(p, s)
                   : launch_word_fast<false>(p, s);
    }
  }
  p.rows = generic_rows(N | 1);
  const int blocks = (B + p.rows - 1) / p.rows;
  const int smem = 4 * p.rows * (N | 1);
  if (prune)
    return launch(word_generic_kernel<CAP, true>, p, blocks, p.rows, smem, s);
  return launch(word_generic_kernel<CAP, false>, p, blocks, p.rows, smem, s);
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
    case -6: return "a word may have at most 16000 symbols";
    default: return code > 0 ? cudaGetErrorString((cudaError_t)code) : "ok";
  }
}

// Rows per thread block and bytes of shared memory of a launch over
// 16-byte aligned inputs: kind 0-2 the segment bodies (paa, linfit,
// sqdist) over rows of length n with N segments, kind 3 the word gather
// over N-symbol words (the table's static bytes included).  sqdist's
// register body holds sqdist_warp_rows(n) rows a warp and no shared
// memory.
int level_ops_tile(int kind, int n, int N, int* smem) {
  if (kind == 3) {
    if (word_fast(N)) {
      *smem = 4 * TABLE_FLOATS;
      return NTHREADS;
    }
    const int rows = generic_rows(N | 1);
    *smem = 4 * TABLE_FLOATS + 4 * rows * (N | 1);
    return rows;
  }
  if (kind == LINFIT) {
    const int L = n / N;
    if (linfit_fast(L, N)) {
      *smem = 0;
      return WARPS * (32 / N);
    }
    const int floats = linfit_slice_floats(L, N);
    const int rows = generic_rows(floats);
    *smem = 4 * rows * floats;
    return rows;
  }
  if (kind == SQDIST && sqdist_fast(n)) {
    *smem = 0;
    return WARPS * sqdist_warp_rows(n);
  }
  const int rows = seg_rows(kind, n);
  *smem = 4 * seg_tile_floats(kind, n, rows);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = n / N;
  if (body == LINFIT) {
    LinfitParams p{};
    p.x = x; p.B = B; p.n = n; p.N = N; p.L = L;
    p.inv_L = 1.0f / (float)L;
    const double sxx = (double)L * ((double)L * L - 1.0) / 12.0;
    p.inv_sxx = L > 1 ? 1.0f / (float)sxx : 0.f;
    p.out = out;
    const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (dtype == BF16) return launch_linfit<__nv_bfloat16>(p, aligned, s);
    return launch_linfit<float>(p, aligned, s);
  }
  SegParams p{};
  p.x = x; p.q = q; p.q_bf16 = q_dtype == BF16;
  p.B = B; p.n = n; p.N = N; p.L = L;
  p.rows = seg_rows(body, n);
  p.inv_L = 1.0f / (float)L;
  p.out = out;
  const int smem = 4 * seg_tile_floats(body, n, p.rows);
  if (body == PAA) return launch_seg<PAA>(p, dtype, smem, s);
  if (sqdist_fast(n))
    return dtype == BF16 ? launch_sqdist<__nv_bfloat16>(p, s)
                         : launch_sqdist<float>(p, s);
  return launch_seg<SQDIST>(p, dtype, smem, s);
}

// Kernels 10 (prune = 0: (B,) f32 MINDIST² into out) and 12 (prune = 1:
// (B,) bool alive' into out from alive, res, qres, eps and eps2 = ε·ε in
// f32) over (B, N) int32 words, the device's (alphabet, alphabet) MINDIST
// table tab and one query word given on the host as N offsets
// qoff[i] = q_i·alphabet, copied into the launch's parameters.
int level_word_launch(int prune, const int* words, int B, int N,
                      int alphabet, const float* tab,
                      const unsigned short* qoff, float scale,
                      const unsigned char* alive, const float* res,
                      float qres, float eps, float eps2, void* out,
                      void* stream) {
  if (B < 1 || N < 1) return -3;
  if (alphabet < 2 || alphabet > MAX_ALPHABET) return -4;
  if (N > WORD_N_MAX) return -6;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= QOFF_SHORT)
    return launch_word<QOFF_SHORT>(prune, words, B, N, alphabet, tab, qoff,
                                   scale, alive, res, qres, eps, eps2, out,
                                   s);
  return launch_word<WORD_N_MAX>(prune, words, B, N, alphabet, tab, qoff,
                                 scale, alive, res, qres, eps, eps2, out, s);
}

}  // extern "C"
