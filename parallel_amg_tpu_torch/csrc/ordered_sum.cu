// Float32 row sums and row dot products in a fixed order: the order the JAX
// package's CPU backend adds them (ops/ordered_sum.py has the rules).  Not a
// port of a TPU kernel: the RS setups and every power iteration need XLA's
// CPU order so that the port's floats are the JAX package's bits.
//
// ordered_sum: x is (rows, d1, d2), row-major and contiguous; out[r] is the
// sum of row r over XLA's whole tree of windows.  Each reduced axis of more
// than 32 is cut into windows of 32 with the zero padding split before and
// after (an axis of 32 or fewer is one window); a window is added from +0.0
// one element at a time in row-major order, padding skipped; the windows'
// partial sums form a smaller array that is summed by the same rule, until
// one window is left.  Three kernels, chosen by the C entry point:
//
//  - ordered_sum_staged: rows of at most kMaxStagedRow floats with no
//    windows; a block copies its 128 rows (one contiguous span) to shared
//    memory with coalesced loads at an odd row stride, a thread adds a row.
//  - ordered_sum_windows: the whole tree of a row in one block.  A group of
//    G threads (32 or 128) takes a row: it copies a span of G windows of a
//    one-axis row to shared memory with coalesced loads, skewed by one float
//    every 32 so that the threads' windows (32 floats apart) fall in distinct
//    banks; each thread adds its window; the partials stay in shared memory
//    and each further level of windows is added there, down to the result.
//    Two-axis rows read their first level straight from device memory.
//  - ordered_sum_windows_span: one-axis rows of more than kMaxParts windows
//    (e.g. a norm over 2^20 floats): a warp takes one window of the second
//    level (32 windows of 32 consecutive floats), stages it, adds the 32
//    windows and then their partials; the block that finishes last adds the
//    second level's partials as ordered_sum_windows does.  One launch for any
//    length up to 2^25.
//
// ordered_sum_lanes: rows of `len` in the order of LLVM's vectorised
// reduction loop (lanes = (vf, ic, evf)): ic accumulators of vf lanes over
// whole blocks of vf·ic elements (lane 0 starts at +0.0, every other lane at
// -0.0, LLVM's neutral element) added lanewise and halved; then blocks of evf
// lanes starting from that sum in lane 0; then the rest one at a time.  Without b each step adds a[r, k]; with b it is __fmaf_rn(a, b, acc),
// the fused multiply-add XLA's CPU backend contracts a product and its sum
// into.  The schedules are template arguments, so the accumulators live in
// registers; a schedule with no instance is refused (cudaErrorInvalidValue).
// Row-major rows of at most 32 are staged in shared memory as above (16-byte
// loads where the span is aligned); with
// `planes` the operands are (len, rows) planes, read coalesced as they are;
// vf = 1 (one chain) takes rows of any length.
//
// ordered_fma: out[i] = fma(a, b, c) rounded once (__fmaf_rn), the product
// and add XLA's CPU backend contracts in an elementwise loop (the centre
// planes of the Galerkin smoothers); an operand shorter than out repeats (a
// scalar, or a grid broadcast over the leading axes).
//
// ordered_bucket_stage: one stage of the structured setups' bucketed
// Galerkin product (ops/bucket_stage.py has the order), Y[o](p) = the terms
// applied to output box o in order, each select(mask, F[k](p), 0) *
// X[src](p + off): the first a rounded product (__fmul_rn), the rest
// __fmaf_rn, a masked-off term computed, not skipped (fma(+0, x, -0) is
// +0).  It replaces, per stage, a shifted copy of X for every offset, a mask
// tensor and an ordered_fma launch per contiguous block of every update (a
// launch per box plane on 27-point levels).  A thread a grid point and up to
// 27 output boxes, their sums in registers: each term's mask, factor and
// neighbor are computed once for the point and applied to every box of its
// target (a host table of source boxes, uniform over the block), so F is
// read once and X's reads are the boxes' own.  Bound: device-memory bytes,
// F, X and Y each once; a point's reads of X's neighbors go through L1/L2.
//
// Every add is __fadd_rn and every fused multiply-add __fmaf_rn (no other
// contraction, no reassociation, no atomics: the file is built without fast
// math), so each result is the plain version's bit for bit.  Bound: device
// memory bytes (each input read once); the sums are serial by definition, so
// the designs keep every load coalesced and give each thread its own chain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kWindow = 32;
constexpr int kMaxStagedRow = 64;  // floats of one row staged by ordered_sum_staged
constexpr int kMaxParts = 1024;    // first-level windows a row may have in one block

struct Win {
  int w, n, lo;  // window length, number of windows, leading padding
};

__host__ __device__ inline Win windows(int d) {
  if (d <= kWindow) return {d, 1, 0};
  const int n = (d + kWindow - 1) / kWindow;
  return {kWindow, n, (n * kWindow - d) / 2};
}

// one float of skew every 32: element i of a staged span sits at skew(i)
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kBlock)
ordered_sum_staged(const float* __restrict__ x, float* __restrict__ out,
                   long long rows, int len) {
  extern __shared__ float tile[];
  const int stride = len | 1;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlock;
  const int n_rows = static_cast<int>(min(static_cast<long long>(kBlock), rows - r0));
  const float* span = x + r0 * len;
  const int n = n_rows * len;
  for (int e = threadIdx.x; e < n; e += kBlock) {
    const int r = e / len;
    tile[r * stride + (e - r * len)] = span[e];
  }
  __syncthreads();
  if (threadIdx.x >= n_rows) return;
  const float* row = tile + threadIdx.x * stride;
  float acc = 0.0f;
  for (int j = 0; j < len; ++j) acc = __fadd_rn(acc, row[j]);
  out[r0 + threadIdx.x] = acc;
}

// shared floats of one row group of ordered_sum_windows<G>: the staged span
// and two buffers of partials
template <int G>
struct WindowsSmem {
  static constexpr int kStage = G * kWindow + G;
  static constexpr int kPart = (G == kWindow ? kWindow : kMaxParts) + kMaxParts / kWindow;
  static constexpr int kGroup = kStage + 2 * kPart;
  static constexpr int kBytes = (kBlock / G) * kGroup * 4;
};

// Copy row[e_lo, e_hi) to stage[skew(e - start)] with the n_threads threads
// numbered t: 16-byte loads (through L2) over the aligned middle, 4-byte
// loads at the two ends.
__device__ __forceinline__ void stage_span(const float* __restrict__ row, int e_lo, int e_hi,
                                           int start, float* stage, int t, int n_threads) {
  int v_lo = e_lo, v_hi = e_lo;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    v_lo = min((e_lo + 3) & ~3, e_hi);
    v_hi = max(e_hi & ~3, v_lo);
  }
  for (int e = e_lo + t; e < v_lo; e += n_threads) stage[skew(e - start)] = __ldcg(row + e);
  for (int e4 = v_lo / 4 + t; e4 < v_hi / 4; e4 += n_threads) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(row) + e4);
    const int e = 4 * e4 - start;
    stage[skew(e)] = v.x;
    stage[skew(e + 1)] = v.y;
    stage[skew(e + 2)] = v.z;
    stage[skew(e + 3)] = v.w;
  }
  for (int e = v_hi + t; e < e_hi; e += n_threads) stage[skew(e - start)] = __ldcg(row + e);
}

// the sum of window [base, base + 32) of a one-axis array of n (padding +0.0,
// which leaves a sum from +0.0 unchanged); at(e) reads element e
template <typename At>
__device__ __forceinline__ float window_sum(int base, int n, At at) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    const int e = base + k;
    acc = __fadd_rn(acc, (e >= 0 && e < n) ? at(e) : 0.0f);
  }
  return acc;
}

// The whole tree of windows of one (d1, d2) row by a group of G threads; the
// result is valid in the group's thread 0.  `stage` holds a span of G windows
// of a one-axis row (skewed), `src` and `dst` the partials of one level each.
// Every thread of the block calls it with the same (d1, d2).
template <int G>
__device__ float row_tree(const float* __restrict__ row, int d1, int d2, float* stage,
                          float* src, float* dst, int t, bool live) {
  const Win a1 = windows(d1), b1 = windows(d2);
  float result = 0.0f;
  if (a1.n * b1.n == 1) {  // no windows: one sum, left to right
    if (live && t == 0)
      for (int e = 0; e < d1 * d2; ++e) result = __fadd_rn(result, __ldcg(row + e));
    return result;
  }
  // first level of windows into src
  if (d1 == 1) {
    for (int c0 = 0; c0 < b1.n; c0 += G) {
      const int start = c0 * kWindow - b1.lo;  // the span's first element, maybe padding
      const int e_lo = max(start, 0), e_hi = min(start + G * kWindow, d2);
      if (live) stage_span(row, e_lo, e_hi, start, stage, t, G);
      __syncthreads();
      const int c = c0 + t;
      if (live && c < b1.n)
        src[skew(c)] = window_sum(c * kWindow - b1.lo, d2,
                                  [&](int e) { return stage[skew(e - start)]; });
      __syncthreads();
    }
  } else {
    if (live)
      for (int c = t; c < a1.n * b1.n; c += G) {
        const int a = c / b1.n, b = c - a * b1.n;
        const int i0 = a * a1.w - a1.lo, j0 = b * b1.w - b1.lo;
        const int ie = min(i0 + a1.w, d1), je = min(j0 + b1.w, d2);
        float acc = 0.0f;
        for (int i = max(i0, 0); i < ie; ++i)
          for (int j = max(j0, 0); j < je; ++j) acc = __fadd_rn(acc, __ldcg(row + i * d2 + j));
        src[skew(c)] = acc;
      }
    __syncthreads();
  }
  // further levels in shared memory, down to one window
  int n1 = a1.n, n2 = b1.n;
  while (true) {
    const Win a = windows(n1), b = windows(n2);
    if (a.n * b.n == 1) {
      if (live && t == 0) {
        const int n = n1 * n2;  // at most 32 · 32
#pragma unroll
        for (int c = 0; c < kWindow; ++c)
          result = __fadd_rn(result, c < n ? src[skew(c)] : 0.0f);
        for (int c = kWindow; c < n; ++c) result = __fadd_rn(result, src[skew(c)]);
      }
      return result;
    }
    if (live)
      for (int c = t; c < a.n * b.n; c += G) {
        if (n1 == 1) {
          dst[skew(c)] = window_sum(c * kWindow - b.lo, n2,
                                    [&](int e) { return src[skew(e)]; });
          continue;
        }
        const int ai = c / b.n, bi = c - ai * b.n;
        const int i0 = ai * a.w - a.lo, j0 = bi * b.w - b.lo;
        const int ie = min(i0 + a.w, n1), je = min(j0 + b.w, n2);
        float acc = 0.0f;
        for (int i = max(i0, 0); i < ie; ++i)
          for (int j = max(j0, 0); j < je; ++j) acc = __fadd_rn(acc, src[skew(i * n2 + j)]);
        dst[skew(c)] = acc;
      }
    __syncthreads();
    n1 = a.n;
    n2 = b.n;
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
}

template <int G>
__global__ void __launch_bounds__(kBlock)
ordered_sum_windows(const float* __restrict__ x, float* __restrict__ out,
                    long long rows, int d1, int d2) {
  using S = WindowsSmem<G>;
  extern __shared__ float smem[];
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const long long r = static_cast<long long>(blockIdx.x) * (kBlock / G) + g;
  const bool live = r < rows;
  float* stage = smem + g * S::kGroup;
  const float* row = x + (live ? r : 0) * d1 * static_cast<long long>(d2);
  const float sum = row_tree<G>(row, d1, d2, stage, stage + S::kStage,
                                stage + S::kStage + S::kPart, t, live);
  if (live && t == 0) out[r] = sum;
}

// One-axis rows of d floats past kMaxParts windows, in one launch: a warp per
// second-level window writes its sum to scratch (rows × n2, n2 =
// windows(windows(d).n).n); the block that finishes last (a counter, not a
// sum, is atomic) adds each row's n2 partials by row_tree and resets the
// counter to 0 for the next launch.
constexpr int kSpanWarps = kBlock / kWindow;

__global__ void __launch_bounds__(kBlock)
ordered_sum_windows_span(const float* __restrict__ x, float* __restrict__ out,
                         float* __restrict__ scratch, unsigned int* counter,
                         long long rows, int d) {
  using S = WindowsSmem<kBlock>;
  extern __shared__ float smem[];
  __shared__ bool last;
  const int w = threadIdx.x / kWindow, t = threadIdx.x % kWindow;
  const Win b1 = windows(d), b2 = windows(b1.n);
  const long long q_all = static_cast<long long>(blockIdx.x) * kSpanWarps + w;
  const long long r = q_all / b2.n;
  const int q = static_cast<int>(q_all - r * b2.n);
  if (r < rows) {
    float* stage = smem + w * (kWindow * kWindow + kWindow);
    float* part = smem + kSpanWarps * (kWindow * kWindow + kWindow) + w * kWindow;
    const float* row = x + r * d;
    const int c_first = q * kWindow - b2.lo;  // first-level windows c_first + t
    const int c_lo = max(c_first, 0), c_hi = min(c_first + kWindow, b1.n);
    const int start = c_first * kWindow - b1.lo;
    const int e_lo = max(c_lo * kWindow - b1.lo, 0);
    const int e_hi = min(c_hi * kWindow - b1.lo, d);
    stage_span(row, e_lo, e_hi, start, stage, t, kWindow);
    __syncwarp();
    const int c = c_first + t;
    part[t] = (c >= c_lo && c < c_hi)
                  ? window_sum(c * kWindow - b1.lo, d,
                               [&](int e) { return stage[skew(e - start)]; })
                  : 0.0f;
    __syncwarp();
    if (t == 0) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kWindow; ++k) acc = __fadd_rn(acc, part[k]);
      scratch[r * b2.n + q] = acc;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (long long rr = 0; rr < rows; ++rr) {
    const float sum = row_tree<kBlock>(scratch + rr * b2.n, 1, b2.n, smem, smem + S::kStage,
                                       smem + S::kStage + S::kPart, threadIdx.x, true);
    if (threadIdx.x == 0) out[rr] = sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// LLVM's reduction of N lanes (a power of 2): lane l += lane l + N/2, ...
template <int N>
__device__ __forceinline__ float halving(float (&v)[N]) {
#pragma unroll
  for (int h = N / 2; h >= 1; h /= 2)
#pragma unroll
    for (int l = 0; l < h; ++l) v[l] = __fadd_rn(v[l], v[l + h]);
  return v[0];
}

// element k of a row: consecutive (a staged row, a row-major row) or `step`
// apart (planes of `rows` values)
struct Contiguous {
  const float* p;
  __device__ __forceinline__ float operator()(int k) const { return p[k]; }
};
struct Strided {
  const float* p;
  long long step;
  __device__ __forceinline__ float operator()(int k) const { return p[k * step]; }
};

template <bool FMA, typename Op>
__device__ __forceinline__ float step_op(float acc, const Op& a, const Op& b, int k) {
  return FMA ? __fmaf_rn(a(k), b(k), acc) : __fadd_rn(acc, a(k));
}

template <int VF, int IC, int EVF, bool FMA, typename Op>
__device__ float lanes_row(const Op& a, const Op& b, int len) {
  constexpr int kStep = VF * IC;
  const int j_end = len / kStep * kStep;
  float s = 0.0f;
  int j = 0;
  if (j_end > 0) {
    float acc[IC][VF];
#pragma unroll
    for (int p = 0; p < IC; ++p)
#pragma unroll
      for (int l = 0; l < VF; ++l) acc[p][l] = (p == 0 && l == 0) ? 0.0f : -0.0f;
    for (; j < j_end; j += kStep)
#pragma unroll
      for (int p = 0; p < IC; ++p)
#pragma unroll
        for (int l = 0; l < VF; ++l)
          acc[p][l] = step_op<FMA, Op>(acc[p][l], a, b, j + p * VF + l);
#pragma unroll
    for (int p = 1; p < IC; ++p)
#pragma unroll
      for (int l = 0; l < VF; ++l) acc[0][l] = __fadd_rn(acc[0][l], acc[p][l]);
    s = halving<VF>(acc[0]);
  }
  constexpr int kE = EVF > 0 ? EVF : 1;
  if (EVF > 0 && len - j >= kE) {
    float e[kE];
#pragma unroll
    for (int l = 0; l < kE; ++l) e[l] = l == 0 ? s : -0.0f;
    const int end = j + (len - j) / kE * kE;
    for (; j < end; j += kE)
#pragma unroll
      for (int l = 0; l < kE; ++l) e[l] = step_op<FMA, Op>(e[l], a, b, j + l);
    s = halving<kE>(e);
  }
  for (; j < len; ++j) s = step_op<FMA, Op>(s, a, b, j);
  return s;
}

template <int VF, int IC, int EVF, bool FMA>
__global__ void __launch_bounds__(kBlock)
ordered_sum_lanes(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, long long rows, int len, int planes) {
  extern __shared__ float tile[];  // staged rows: a, then b, at stride len | 1
  const long long r0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long r = r0 + threadIdx.x;
  const bool staged = !planes && len <= kWindow;
  const int stride = len | 1;
  if (staged) {
    // the block's rows are one contiguous span: 16-byte loads where aligned
    const int n_rows = static_cast<int>(min(static_cast<long long>(kBlock), rows - r0));
    const int n = n_rows * len;
    const float* a0 = a + r0 * len;
    const float* b0 = FMA ? b + r0 * len : a0;
    const bool vec = (reinterpret_cast<uintptr_t>(a0) | reinterpret_cast<uintptr_t>(b0)) % 16 == 0;
    const int n4 = vec ? n / 4 : 0;
    // element e is row e / len of the block: e < 4,096 and len ≤ 32, so a
    // float reciprocal gives the quotient exactly, without an integer divide
    const float inv_len = 1.0f / static_cast<float>(len);
    for (int e4 = threadIdx.x; e4 < n4; e4 += kBlock) {
      const float4 va = reinterpret_cast<const float4*>(a0)[e4];
      const float4 vb = FMA ? reinterpret_cast<const float4*>(b0)[e4] : va;
      const float xa[4] = {va.x, va.y, va.z, va.w}, xb[4] = {vb.x, vb.y, vb.z, vb.w};
      int q = static_cast<int>((4 * e4 + 0.5f) * inv_len), k = 4 * e4 - q * len;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tile[q * stride + k] = xa[i];
        if (FMA) tile[kBlock * stride + q * stride + k] = xb[i];
        if (++k == len) k = 0, ++q;
      }
    }
    for (int e = 4 * n4 + threadIdx.x; e < n; e += kBlock) {
      const int q = static_cast<int>((e + 0.5f) * inv_len), k = e - q * len;
      tile[q * stride + k] = a0[e];
      if (FMA) tile[kBlock * stride + q * stride + k] = b0[e];
    }
    __syncthreads();
  }
  if (r >= rows) return;
  if (staged)
    out[r] = lanes_row<VF, IC, EVF, FMA>(Contiguous{tile + threadIdx.x * stride},
                                         Contiguous{tile + (kBlock + threadIdx.x) * stride}, len);
  else if (planes)
    out[r] = lanes_row<VF, IC, EVF, FMA>(Strided{a + r, rows}, Strided{FMA ? b + r : b, rows},
                                         len);
  else
    out[r] = lanes_row<VF, IC, EVF, FMA>(Contiguous{a + r * len},
                                         Contiguous{FMA ? b + r * len : b}, len);
}

template <int VF, int IC, int EVF, bool FMA>
int launch_lanes(const float* a, const float* b, float* out, long long rows, int len,
                 int planes, cudaStream_t s) {
  const long long blocks = (rows + kBlock - 1) / kBlock;
  const bool staged = !planes && len <= kWindow;
  const size_t smem = staged ? sizeof(float) * kBlock * (len | 1) * (FMA ? 2 : 1) : 0;
  ordered_sum_lanes<VF, IC, EVF, FMA>
      <<<static_cast<unsigned>(blocks), kBlock, smem, s>>>(a, b, out, rows, len, planes);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_windows(const float* x, float* out, long long rows, int d1, int d2,
                   cudaStream_t s) {
  const long long blocks = (rows + kBlock / G - 1) / (kBlock / G);
  ordered_sum_windows<G><<<static_cast<unsigned>(blocks), kBlock,
                           WindowsSmem<G>::kBytes, s>>>(x, out, rows, d1, d2);
  return static_cast<int>(cudaGetLastError());
}

int windows_full(const float* x, float* out, long long rows, int d1, int d2,
                 cudaStream_t s) {
  const int parts = windows(d1).n * windows(d2).n;
  return parts <= kWindow ? launch_windows<kWindow>(x, out, rows, d1, d2, s)
                          : launch_windows<kBlock>(x, out, rows, d1, d2, s);
}

__global__ void __launch_bounds__(kBlock)
    ordered_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* c, float* out, long long n,
                       long long na, long long nb, long long nc) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x; i < n;
       i += stride)
    out[i] = __fmaf_rn(a[na == n ? i : i % na], b[nb == n ? i : i % nb],
                       c[nc == n ? i : i % nc]);
}

// One term of ordered_bucket_stage's table, kTermInts int32s: kind (0: store
// the rounded product, 1: fused multiply-add into y), the factor plane k, the
// fine offset, and the residue window's start lo = delta * b - off on each
// axis (the point's delta is the term's where lo <= p mod b < lo + b).  Beside
// it, per term, the source box (a linear index of X's box) of every output
// box, -1 where the output box is not in the term's target.
constexpr int kTermInts = 8;
// output boxes a thread accumulates in registers (a box of 3 x 3 x 3)
constexpr int kBoxGroup = 27;

// A thread a grid point p and a group of up to kBoxGroup output boxes
// (blockIdx.y): the y of each box from +0, then every term in order, its
// mask (the residue window on every axis), select(mask, F[k](p), 0) and the
// neighbor p + off computed once for the point, then applied to each box of
// the group in the term's target, x read in place in the box's source (0 off
// the grid).  Each box's chain is the table's order restricted to that box,
// which is the JAX package's order for it.  A masked-off term is computed
// (fma(+0, x, y)), never skipped.
__global__ void __launch_bounds__(kBlock)
    ordered_bucket_stage_kernel(const float* __restrict__ F, const float* __restrict__ X,
                                float* __restrict__ Y, const int* __restrict__ terms,
                                const int* __restrict__ src, int n_terms, int n_box_out,
                                int n_cols, int n0, int n1, int n2, int b) {
  const int n = n0 * n1 * n2;  // < 2^31, checked by the entry
  const int plane = n1 * n2;
  const int g0 = blockIdx.y * kBoxGroup;
  const unsigned ub = static_cast<unsigned>(b);
  for (long long pl = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; pl < n;
       pl += static_cast<long long>(gridDim.x) * kBlock) {
    const int p = static_cast<int>(pl);
    const int p0 = p / plane;
    const int rest = p - p0 * plane;
    const int p1 = rest / n2, p2 = rest - p1 * n2;
    const int r0 = p0 % b, r1 = p1 % b, r2 = p2 % b;
    float y[kBoxGroup];
#pragma unroll
    for (int j = 0; j < kBoxGroup; ++j) y[j] = 0.f;
    for (int t = 0; t < n_terms; ++t) {
      const int* u = terms + t * kTermInts;
      const int kind = __ldg(u), k = __ldg(u + 1);
      const int o0 = __ldg(u + 2), o1 = __ldg(u + 3), o2 = __ldg(u + 4);
      const bool mask = static_cast<unsigned>(r0 - __ldg(u + 5)) < ub &&
                        static_cast<unsigned>(r1 - __ldg(u + 6)) < ub &&
                        static_cast<unsigned>(r2 - __ldg(u + 7)) < ub;
      const float f = mask ? __ldg(F + static_cast<long long>(k) * n + p) : 0.f;
      const int q0 = p0 + o0, q1 = p1 + o1, q2 = p2 + o2;
      const bool inside = static_cast<unsigned>(q0) < static_cast<unsigned>(n0) &&
                          static_cast<unsigned>(q1) < static_cast<unsigned>(n1) &&
                          static_cast<unsigned>(q2) < static_cast<unsigned>(n2);
      const int q = q0 * plane + q1 * n2 + q2;
      const int* s = src + t * n_cols + g0;
#pragma unroll
      for (int j = 0; j < kBoxGroup; ++j) {
        const int box = __ldg(s + j);  // uniform over the block
        if (box >= 0) {
          const float x = inside ? __ldg(X + static_cast<long long>(box) * n + q) : 0.f;
          y[j] = kind == 0 ? __fmul_rn(f, x) : __fmaf_rn(f, x, y[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBoxGroup; ++j) {
      if (g0 + j < n_box_out) Y[static_cast<long long>(g0 + j) * n + p] = y[j];
    }
  }
}

}  // namespace

// out[i] = fma(a[i % na], b[i % nb], c[i % nc]) for i < n on `stream`: an
// operand of fewer than n elements repeats (a scalar, or a trailing grid
// broadcast over leading axes).  out may be c itself (nc = n: an update in
// place; each element is read before the same thread writes it).  Returns
// the launch's cudaError_t.
extern "C" int ordered_fma(const void* a, const void* b, const void* c, void* out,
                           long long n, long long na, long long nb, long long nc,
                           void* stream) {
  if (n == 0) return 0;
  if (na <= 0 || nb <= 0 || nc <= 0 || n % na || n % nb || n % nc)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kBlock - 1) / kBlock;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  ordered_fma_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(out), n, na, nb, nc);
  return static_cast<int>(cudaGetLastError());
}

// One bucketed Galerkin stage Y[o](p) = sum over the terms applied to o of
// select(mask, F[k](p), 0) * X[src](p + off), Y (n_box_out, n0, n1, n2), X
// (n_box_in, n0, n1, n2), F (K, n0, n1, n2), all float32 and contiguous, in
// one launch on `stream`: terms (n_terms x kTermInts int32s) in the order
// the JAX package's CPU code applies them, src (n_terms x n_cols int32s, n_cols
// a multiple of kBoxGroup covering n_box_out) each term's source box per
// output box or -1, b the block size of the residue test; fewer than 2^31
// grid points.  Returns the launch's cudaError_t.
extern "C" int ordered_bucket_stage(const void* F, const void* X, void* Y, const void* terms,
                                    const void* src, int n_terms, int n_box_out, int n_cols,
                                    int n0, int n1, int n2, int b, void* stream) {
  const long long n = static_cast<long long>(n0) * n1 * n2;
  if (n_terms < 0 || n_box_out < 0 || n_cols % kBoxGroup != 0 || n_cols < n_box_out ||
      n0 < 0 || n1 < 0 || n2 < 0 || b < 1 || n >= (1LL << 31) ||
      static_cast<long long>(n_terms) * n_cols >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_box_out == 0 || n == 0) return 0;
  const long long chunks = (n + kBlock - 1) / kBlock;
  const dim3 grid(static_cast<unsigned>(chunks < (1LL << 20) ? chunks : (1LL << 20)),
                  static_cast<unsigned>(n_cols / kBoxGroup));
  ordered_bucket_stage_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(F), static_cast<const float*>(X), static_cast<float*>(Y),
      static_cast<const int*>(terms), static_cast<const int*>(src), n_terms, n_box_out,
      n_cols, n0, n1, n2, b);
  return static_cast<int>(cudaGetLastError());
}

// The sum of each row of (rows, d1, d2) float32 x over its whole tree of
// windows into out (rows), on `stream`, in one launch.  A one-axis row (d1 =
// 1) of more than kMaxParts windows takes ordered_sum_windows_span, which
// needs `scratch` (rows × windows(windows(d2).n).n floats) and `counter` (one
// unsigned int, 0 before the launch and after it).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ordered_sum(const void* x, void* out, void* scratch, void* counter,
                           long long rows, int d1, int d2, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  if (rows == 0) return 0;
  const Win a1 = windows(d1), b1 = windows(d2);
  const int len = d1 * d2;
  if (a1.n * b1.n == 1 && len > 0 && len <= kMaxStagedRow) {
    const long long blocks = (rows + kBlock - 1) / kBlock;
    const size_t smem = sizeof(float) * kBlock * (len | 1);
    ordered_sum_staged<<<static_cast<unsigned>(blocks), kBlock, smem, s>>>(xf, of, rows, len);
    return static_cast<int>(cudaGetLastError());
  }
  if (d1 == 1 && b1.n > kMaxParts) {
    const Win b2 = windows(b1.n);
    if (windows(b2.n).n > kMaxParts || scratch == nullptr || counter == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (rows * b2.n + kSpanWarps - 1) / kSpanWarps;
    ordered_sum_windows_span<<<static_cast<unsigned>(blocks), kBlock,
                               WindowsSmem<kBlock>::kBytes, s>>>(
        xf, of, static_cast<float*>(scratch), static_cast<unsigned int*>(counter), rows, d2);
    return static_cast<int>(cudaGetLastError());
  }
  if (a1.n * b1.n > kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
  return windows_full(xf, of, rows, d1, d2, s);
}

// Each row of `len` in LLVM's vectorised order lanes = (vf, ic, evf) into
// out (rows): row-major (rows, len) a and b, or (len, rows) planes; b ==
// nullptr adds a, otherwise each step is a fused multiply-add of a and b.
// Instances: vf = 1 (one chain, any len, both modes); the weak-coupling sums
// (4, 2, 0), (4, 4, 4), (8, 2, 0) adding; the ELL products (8, 1, 4),
// (8, 1, 0) with FMA.  Anything else, or another length than at most 32 for
// vf > 1, returns cudaErrorInvalidValue.
extern "C" int ordered_sum_lanes(const void* a, const void* b, void* out, long long rows,
                                 int len, int vf, int ic, int evf, int planes,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  if (rows == 0) return 0;
  const bool fma = b != nullptr;
  if (vf == 1 && ic == 1 && evf == 0)
    return fma ? launch_lanes<1, 1, 0, true>(af, bf, of, rows, len, planes, s)
               : launch_lanes<1, 1, 0, false>(af, bf, of, rows, len, planes, s);
  if (len > kWindow) return static_cast<int>(cudaErrorInvalidValue);
  if (!fma) {
    if (vf == 4 && ic == 2 && evf == 0)
      return launch_lanes<4, 2, 0, false>(af, bf, of, rows, len, planes, s);
    if (vf == 4 && ic == 4 && evf == 4)
      return launch_lanes<4, 4, 4, false>(af, bf, of, rows, len, planes, s);
    if (vf == 8 && ic == 2 && evf == 0)
      return launch_lanes<8, 2, 0, false>(af, bf, of, rows, len, planes, s);
  } else {
    if (vf == 8 && ic == 1 && evf == 4)
      return launch_lanes<8, 1, 4, true>(af, bf, of, rows, len, planes, s);
    if (vf == 8 && ic == 1 && evf == 0)
      return launch_lanes<8, 1, 0, true>(af, bf, of, rows, len, planes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
