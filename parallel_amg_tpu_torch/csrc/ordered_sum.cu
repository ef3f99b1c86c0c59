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
// vf = 1 (one chain) and the 2-D norms' (vf, 1, 0) take rows of any length.
//
// ordered_fma: out[i] = fma(a, b, c) rounded once (__fmaf_rn), the product
// and add XLA's CPU backend contracts in an elementwise loop (the centre
// planes of the Galerkin smoothers); an operand shorter than out repeats (a
// scalar, or a grid broadcast over the leading axes).
//
// ordered_bucket_stage: one stage of the structured setups' bucketed
// Galerkin product (ops/bucket_stage.py has the order).  It replaces no TPU
// kernel: it carries XLA's CPU order of the JAX package's bucketed stage, so
// that the port's coarse operators are the JAX package's bits.  Y[o](p) = the
// terms applied to output box o in order, each select(mask, F[k](p), 0) *
// X[src](p + off): stored rounded (__fmul_rn), fused (__fmaf_rn) or added
// rounded (__fadd_rn of __fmul_rn) by the term's kind, another kind on the
// last axis from the term's tail column on; a masked-off term is computed,
// not skipped (fma(+0, x, -0) is +0).  Bounds on an H100: bytes F, X and Y
// once each (config #3's stage 3 at 128^3: 7 + 27 + 27 planes of 2^21
// floats); operations two a (term, output box) pair a point, which at 27
// points is 2 x 2,197 a point and bounds 52^3 rather than its bytes.  Design
// (2.5-D blocking): a block of kTile1 x kTile2 threads owns a tile of (n1, n2)
// points and marches along axis 0 over a chunk of planes, keeping in shared
// memory a ring of 2 r0 + 2 planes (the stencil's reach r, and the plane
// prefetched) of every input box over the tile and its halo, zero off the
// grid, and two planes of the factors; so each of a point's term-box reads is
// a shared-memory load, and X and F come from device memory once a chunk plus
// the halo.  The next plane is fetched while the current one is computed:
// X as float4 loads into registers stored to the ring after the step (rows of
// whole float4s, n2 % 4 == 0; else 4-byte cp.async), F by cp.async.  The
// term table (per term its kind, tail kind, tail, alt, plane, offset and
// residue window) and the block's source entries (a box's offset in the ring)
// are copied to shared memory once a block.  A thread owns a point and up to
// kBoxGroup output boxes (blockIdx.z a group), their sums in registers; a
// term with more than kSparseMax boxes reads all of its 27 entries in three
// passes (entries, x, updates) with no branch, so the loads issue back to
// back, and one with fewer (every term of a stage whose X is one box) walks
// its packed boxes.  The chunk length is chosen for the fewest steps a block
// runs in sequence at the occupancy the launch gets.  A term flagged alt
// reads X_alt from device memory (the JAX package's consumer fusions that
// recompute the previous stage's last update with its product rounded); with
// Y_alt the last term is also added rounded into Y_alt.  Where the ring would
// not fit in shared memory (many input boxes or a wide reach) X and F are read
// from device memory.
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
// the rounded product, 1: fused multiply-add into y, 2: add the rounded
// product), the kind from the tail column on, the tail column (on the last
// axis), alt (read X_alt), the factor plane k, the fine offset, and the
// residue window's start lo = delta * b - off on each axis (the point's delta
// is the term's where lo <= p mod b < lo + b), 0.  Beside it, per term, the
// source box (a linear index of X's box) of every output box, -1 where the
// output box is not in the term's target.
constexpr int kTermInts = 12;
// output boxes a thread accumulates in registers (a box of 3 x 3 x 3)
constexpr int kBoxGroup = 27;
// a block's tile of (n1, n2) points and its threads
constexpr int kTile1 = 8;
constexpr int kTile2 = 32;
constexpr int kStageThreads = kTile1 * kTile2;
// a term's source entries in shared memory, padded to whole int4 loads
constexpr int kEntStride = 28;
// a term's row in shared memory: its kTermInts (the last, 11, replaced by the
// number of boxes it targets), then up to kSparseMax packed boxes
constexpr int kRowStride = 16;
// float4 a thread holds in registers for one plane of the ring (vec path:
// rows of n2 % 4 == 0 floats, a halo of at most 4 columns)
constexpr int kMaxVec = 12;
constexpr int kVecCols = (kTile2 + 8) / 4;
// shared memory a block may take (the H100's opt-in limit)
constexpr size_t kStageSmemMax = 227 * 1024;

struct StageShape {
  int n_terms, n_in, n_out, n_cols, n_f, n0, n1, n2, b, r0, r1, r2, chunk, tiles2;
};

// The block's shared memory: the table (rows, then the int32 source entries:
// a box's offset in the ring, staged, else its index; -1 where absent);
// then, staged, a ring of 2 r0 + 2 slots (the planes a
// step reads and the one prefetched) of every input box over the tile and its
// halo, and two slots of the factor planes over the tile.
__host__ __device__ inline size_t stage_table_bytes(int n_terms) {
  return sizeof(int) * n_terms * (kRowStride + kEntStride);
}
__host__ __device__ inline int stage_slots(const StageShape& s) { return 2 * s.r0 + 2; }
__host__ __device__ inline size_t stage_ring_floats(const StageShape& s) {
  return static_cast<size_t>(s.n_in) * stage_slots(s) * (kTile1 + 2 * s.r1) *
             (kTile2 + 2 * s.r2) +
         2 * static_cast<size_t>(s.n_f) * kStageThreads;
}

// 4 bytes global -> shared without a register, zero-filled where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One term on the y of every box of the group: kind K (0 store, 1 fma, 2 add
// rounded), the x of entry e (>= 0; -1: the box is not in the term's target,
// y kept) read by `read`.  No branch, in three passes (the entries, then
// every x, then the updates, a select keeping y where absent), so the 27
// loads of each pass issue back to back.
template <int K, typename Read>
__device__ __forceinline__ void stage_apply(float (&y)[kBoxGroup], const int* entries,
                                            float f, Read read) {
  int e[kEntStride];
  const int4* e4 = reinterpret_cast<const int4*>(entries);
#pragma unroll
  for (int v = 0; v < kEntStride / 4; ++v) {
    const int4 w = e4[v];  // uniform over the block
    e[4 * v] = w.x;
    e[4 * v + 1] = w.y;
    e[4 * v + 2] = w.z;
    e[4 * v + 3] = w.w;
  }
  float x[kBoxGroup];
#pragma unroll
  for (int j = 0; j < kBoxGroup; ++j) x[j] = read(e[j] >= 0 ? e[j] : 0);
#pragma unroll
  for (int j = 0; j < kBoxGroup; ++j) {
    const float v = K == 0 ? __fmul_rn(f, x[j])
                           : (K == 1 ? __fmaf_rn(f, x[j], y[j])
                                     : __fadd_rn(y[j], __fmul_rn(f, x[j])));
    y[j] = e[j] >= 0 ? v : y[j];
  }
}

// One term on the y of the few boxes it targets (terms with at most
// kSparseMax boxes, as every term of a stage whose X is one box): the packed
// (j << 24 | entry) list, each box's y picked by a switch on j.
constexpr int kSparseMax = 4;
template <int K>
__device__ __forceinline__ void stage_one(float (&y)[kBoxGroup], int j, float f, float x) {
  switch (j) {
#define STAGE_ONE_CASE(J)                                                                 \
  case J:                                                                                 \
    y[J] = K == 0 ? __fmul_rn(f, x)                                                       \
                  : (K == 1 ? __fmaf_rn(f, x, y[J]) : __fadd_rn(y[J], __fmul_rn(f, x))); \
    break;
    STAGE_ONE_CASE(0) STAGE_ONE_CASE(1) STAGE_ONE_CASE(2) STAGE_ONE_CASE(3)
    STAGE_ONE_CASE(4) STAGE_ONE_CASE(5) STAGE_ONE_CASE(6) STAGE_ONE_CASE(7)
    STAGE_ONE_CASE(8) STAGE_ONE_CASE(9) STAGE_ONE_CASE(10) STAGE_ONE_CASE(11)
    STAGE_ONE_CASE(12) STAGE_ONE_CASE(13) STAGE_ONE_CASE(14) STAGE_ONE_CASE(15)
    STAGE_ONE_CASE(16) STAGE_ONE_CASE(17) STAGE_ONE_CASE(18) STAGE_ONE_CASE(19)
    STAGE_ONE_CASE(20) STAGE_ONE_CASE(21) STAGE_ONE_CASE(22) STAGE_ONE_CASE(23)
    STAGE_ONE_CASE(24) STAGE_ONE_CASE(25) STAGE_ONE_CASE(26)
#undef STAGE_ONE_CASE
    default:
      break;
  }
}
template <int K, typename Read>
__device__ __forceinline__ void stage_sparse(float (&y)[kBoxGroup], const int* packed, int count,
                                             float f, Read read) {
  for (int i = 0; i < count; ++i) {
    const int pk = packed[i];  // uniform over the block
    stage_one<K>(y, pk >> 24, f, read(pk & 0xffffff));
  }
}

// NV: float4 a thread holds for a plane of the ring (the vec path), 0: the
// ring filled by 4-byte asynchronous copies
template <bool STAGED, int NV>
__global__ void __launch_bounds__(kStageThreads)
    ordered_bucket_stage_kernel(const float* __restrict__ F, const float* __restrict__ X,
                                const float* __restrict__ Xalt, float* __restrict__ Y,
                                float* __restrict__ Yalt, const int* __restrict__ terms,
                                const int* __restrict__ src, const StageShape sh) {
  extern __shared__ __align__(16) float stage_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(stage_smem);
  int* s_rows = reinterpret_cast<int*>(base);
  int* s_ent = s_rows + sh.n_terms * kRowStride;
  float* ring = reinterpret_cast<float*>(base + stage_table_bytes(sh.n_terms));
  const int tid = threadIdx.y * kTile2 + threadIdx.x;
  const int g0 = blockIdx.z * kBoxGroup;
  const int S = stage_slots(sh), H1 = kTile1 + 2 * sh.r1, H2 = kTile2 + 2 * sh.r2;
  const int slot_floats = H1 * H2, box_floats = S * slot_floats;
  for (int i = tid; i < sh.n_terms * kTermInts; i += kStageThreads)
    s_rows[i / kTermInts * kRowStride + i % kTermInts] = terms[i];
  for (int i = tid; i < sh.n_terms * kEntStride; i += kStageThreads) {
    const int t = i / kEntStride, j = i - t * kEntStride;
    const int box = j < kBoxGroup ? src[static_cast<long long>(t) * sh.n_cols + g0 + j] : -1;
    // a term read from the ring (staged, not alt) keeps the box's offset
    s_ent[i] = box >= 0 && STAGED && !terms[t * kTermInts + 3] ? box * box_floats : box;
  }
  __syncthreads();
  for (int t = tid; t < sh.n_terms; t += kStageThreads) {  // each term's boxes, packed
    int count = 0;
    for (int j = 0; j < kBoxGroup; ++j) {
      const int e = s_ent[t * kEntStride + j];
      if (e >= 0) {
        if (count < kSparseMax) s_rows[t * kRowStride + kTermInts + count] = (j << 24) | e;
        ++count;
      }
    }
    s_rows[t * kRowStride + 11] = count;
  }
  const int n1 = sh.n1, n2 = sh.n2, n0 = sh.n0, b = sh.b;
  const int plane = n1 * n2;
  const long long n = static_cast<long long>(n0) * plane;
  const int base1 = (blockIdx.x / sh.tiles2) * kTile1;
  const int base2 = (blockIdx.x % sh.tiles2) * kTile2;
  const int i1 = base1 + threadIdx.y, i2 = base2 + threadIdx.x;
  float* fring = ring + static_cast<size_t>(sh.n_in) * box_floats;  // 2 x n_f x tile
  const int c0 = blockIdx.y * sh.chunk;
  const int c1 = min(c0 + sh.chunk, n0);
  const bool own = i1 < n1 && i2 < n2;
  const unsigned ub = static_cast<unsigned>(b);
  auto slot_of = [S](int q0) { return ((q0 % S) + S) % S; };
  // asynchronous copies of plane q0 of every input box (tile and halo) into
  // its ring slot, zero off the grid
  auto issue_x = [&](int q0) {
    float* dst = ring + slot_of(q0) * slot_floats;
    const bool in0 = q0 >= 0 && q0 < n0;
    for (int box = 0; box < sh.n_in; ++box) {
      const float* xs = X + (static_cast<long long>(box) * n0 + (in0 ? q0 : 0)) * plane;
      for (int h1 = threadIdx.y; h1 < H1; h1 += kTile1) {
        const int g1 = base1 - sh.r1 + h1;
        const bool in1 = in0 && g1 >= 0 && g1 < n1;
        for (int h2 = threadIdx.x; h2 < H2; h2 += kTile2) {
          const int g2 = base2 - sh.r2 + h2;
          const bool in = in1 && g2 >= 0 && g2 < n2;
          cp_async4(dst + box * box_floats + h1 * H2 + h2, in ? xs + g1 * n2 + g2 : X, in);
        }
      }
    }
  };
  // vec path: plane q0 of every input box (the tile's rows, 4 columns of halo
  // each side) as float4 loads into registers, then into its ring slot
  const int n_vec = sh.n_in * H1 * kVecCols;
  float4 vbuf[NV > 0 ? NV : 1];
  auto load_x4 = [&](int q0) {
    const bool in0 = q0 >= 0 && q0 < n0;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int c = tid + m * kStageThreads;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < n_vec && in0) {
        const int box = c / (H1 * kVecCols), rem = c - box * (H1 * kVecCols);
        const int h1 = rem / kVecCols, c4 = rem - h1 * kVecCols;
        const int g1 = base1 - sh.r1 + h1, g2 = base2 - 4 + 4 * c4;
        if (g1 >= 0 && g1 < n1 && g2 >= 0 && g2 < n2)
          v = __ldg(reinterpret_cast<const float4*>(
              X + (static_cast<long long>(box) * n0 + q0) * plane + g1 * n2 + g2));
      }
      vbuf[m] = v;
    }
  };
  auto store_x4 = [&](int q0) {
    float* dst = ring + slot_of(q0) * slot_floats;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int c = tid + m * kStageThreads;
      if (c < n_vec) {
        const int box = c / (H1 * kVecCols), rem = c - box * (H1 * kVecCols);
        const int h1 = rem / kVecCols, c4 = rem - h1 * kVecCols;
        float* row = dst + box * box_floats + h1 * H2;
        const int h2 = 4 * c4 - 4 + sh.r2;  // the ring column of the float4's first
        const float e[4] = {vbuf[m].x, vbuf[m].y, vbuf[m].z, vbuf[m].w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (h2 + k >= 0 && h2 + k < H2) row[h2 + k] = e[k];
      }
    }
  };
  // the factor planes of plane q0 over the tile into F slot `fs`
  auto issue_f = [&](int q0, int fs) {
    float* dst = fring + fs * sh.n_f * kStageThreads + tid;
    const long long at = static_cast<long long>(q0) * plane + i1 * n2 + i2;
    for (int k = 0; k < sh.n_f; ++k)
      cp_async4(dst + k * kStageThreads, own ? F + k * n + at : F, own);
  };
  if (STAGED) {
    for (int q0 = c0 - sh.r0; q0 <= c0 + sh.r0; ++q0) {
      if (NV > 0) {
        load_x4(q0);
        store_x4(q0);
      } else {
        issue_x(q0);
      }
    }
    issue_f(c0, 0);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  const int r1m = i1 % b, r2m = i2 % b;
  for (int i0 = c0; i0 < c1; ++i0) {
    const bool ahead = STAGED && i0 + 1 < c1;
    if (ahead) {  // prefetch the next step's plane
      if (NV > 0) load_x4(i0 + 1 + sh.r0);
      else issue_x(i0 + 1 + sh.r0);
      issue_f(i0 + 1, (i0 + 1 - c0) & 1);
      cp_async_commit();
    }
    if (own) {
      const int r0m = i0 % b;
      const long long p = static_cast<long long>(i0) * plane + i1 * n2 + i2;
      const float* fs = fring + ((i0 - c0) & 1) * sh.n_f * kStageThreads + tid;
      const int slot0 = slot_of(i0);
      // this thread's point in slot 0 of box 0 of the ring
      const float* at0 = ring + (threadIdx.y + sh.r1) * H2 + threadIdx.x + sh.r2;
      float y[kBoxGroup];
#pragma unroll
      for (int j = 0; j < kBoxGroup; ++j) y[j] = 0.f;
      for (int t = 0; t < sh.n_terms; ++t) {
        const int* u = s_rows + t * kRowStride;
        const int k = u[4], o0 = u[5], o1 = u[6], o2 = u[7];
        const bool mask = static_cast<unsigned>(r0m - u[8]) < ub &&
                          static_cast<unsigned>(r1m - u[9]) < ub &&
                          static_cast<unsigned>(r2m - u[10]) < ub;
        const float fk = STAGED ? fs[k * kStageThreads] : __ldg(F + k * n + p);
        const float f = mask ? fk : 0.f;
        const int kind = i2 >= u[2] ? u[1] : u[0];
        const int* boxes = s_ent + t * kEntStride;
        const int q0 = i0 + o0, q1 = i1 + o1, q2 = i2 + o2;
        const bool inside = static_cast<unsigned>(q0) < static_cast<unsigned>(n0) &&
                            static_cast<unsigned>(q1) < static_cast<unsigned>(n1) &&
                            static_cast<unsigned>(q2) < static_cast<unsigned>(n2);
        const long long q = static_cast<long long>(q0) * plane + q1 * n2 + q2;
        auto apply = [&](auto read) {
          if (t == sh.n_terms - 1 && Yalt != nullptr) {
            // the last term also added rounded, into Y_alt (boxes out of
            // its target keep y)
#pragma unroll
            for (int j = 0; j < kBoxGroup; ++j) {
              if (g0 + j >= sh.n_out) continue;
              const int e = boxes[j];
              const float x = read(e >= 0 ? e : 0);
              Yalt[(g0 + j) * n + p] = e >= 0 ? __fadd_rn(y[j], __fmul_rn(f, x)) : y[j];
            }
          }
          const int count = u[11];
          if (count <= kSparseMax) {
            const int* packed = u + kTermInts;
            if (kind == 1) stage_sparse<1>(y, packed, count, f, read);
            else if (kind == 0) stage_sparse<0>(y, packed, count, f, read);
            else stage_sparse<2>(y, packed, count, f, read);
          } else if (kind == 1) {
            stage_apply<1>(y, boxes, f, read);
          } else if (kind == 0) {
            stage_apply<0>(y, boxes, f, read);
          } else {
            stage_apply<2>(y, boxes, f, read);
          }
        };
        if (u[3]) {  // alt: X_alt from device memory, entries are box indices
          apply([&](int box) { return inside ? __ldg(Xalt + box * n + q) : 0.f; });
        } else if (STAGED) {  // entries are ring offsets
          int sl = slot0 + o0;
          sl += sl < 0 ? S : 0;
          sl -= sl >= S ? S : 0;
          const float* at = at0 + sl * slot_floats + o1 * H2 + o2;
          apply([&](int e) { return at[e]; });
        } else {
          apply([&](int box) { return inside ? __ldg(X + box * n + q) : 0.f; });
        }
      }
#pragma unroll
      for (int j = 0; j < kBoxGroup; ++j) {
        if (g0 + j < sh.n_out) Y[(g0 + j) * n + p] = y[j];
      }
    }
    if (ahead && NV > 0) store_x4(i0 + 1 + sh.r0);  // its slot is not read this step
    if (STAGED) cp_async_wait_all();
    __syncthreads();
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
// select(mask, F[k](p), 0) * X[src](p + off), Y (n_out, n0, n1, n2), X and
// X_alt (n_in, n0, n1, n2), F (K, n0, n1, n2), all float32 and contiguous, in
// one launch on `stream`: F has n_f planes, terms (n_terms x kTermInts int32s)
// in the order the JAX package's CPU code applies them, src (n_terms x n_cols int32s, n_cols a
// multiple of kBoxGroup covering n_out) each term's source box per output box
// or -1, b the block size of the residue test, r0..r2 the terms' reach on
// each axis; X_alt may be null where no term reads it, Y_alt null or Y's
// shape (Y with the last term added rounded); fewer than 2^31 grid points.
// Returns the launch's cudaError_t.
extern "C" int ordered_bucket_stage(const void* F, const void* X, const void* Xalt, void* Y,
                                    void* Yalt, const void* terms, const void* src,
                                    int n_terms, int n_in, int n_out, int n_cols, int n_f,
                                    int n0, int n1, int n2, int b, int r0, int r1, int r2,
                                    void* stream) {
  const long long n = static_cast<long long>(n0) * n1 * n2;
  if (n_terms < 0 || n_in < 1 || n_out < 0 || n_cols % kBoxGroup != 0 || n_cols < n_out ||
      n_f < 1 ||
      n0 < 0 || n1 < 0 || n2 < 0 || b < 1 || r0 < 0 || r1 < 0 || r2 < 0 ||
      n >= (1LL << 31) || n_in >= (1 << 15) ||
      static_cast<long long>(n_terms) * n_cols >= (1LL << 31) ||
      static_cast<long long>(n_in) * n >= (1LL << 31) ||
      static_cast<long long>(n_out) * n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0 || n == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  StageShape sh{n_terms, n_in, n_out, n_cols, n_f, n0, n1, n2, b, r0, r1, r2, 1,
                (n2 + kTile2 - 1) / kTile2};
  // the vec path where rows are whole float4s and a plane fits the registers
  const int vec_chunks = n_in * (kTile1 + 2 * r1) * kVecCols;
  const int nv = n2 % 4 != 0 || r2 > 4 ? 0
                 : vec_chunks <= kStageThreads ? 1
                 : vec_chunks <= kMaxVec * kStageThreads ? kMaxVec : 0;
  const int tiles = ((n1 + kTile1 - 1) / kTile1) * sh.tiles2;
  const int groups = n_cols / kBoxGroup;
  const size_t table = stage_table_bytes(n_terms);
  const size_t staged = table + sizeof(float) * stage_ring_floats(sh);
  const bool use_ring = staged <= kStageSmemMax;
  const size_t smem = use_ring ? staged : table;
  if (smem > kStageSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = !use_ring ? ordered_bucket_stage_kernel<false, 0>
                     : nv == 1 ? ordered_bucket_stage_kernel<true, 1>
                     : nv == kMaxVec ? ordered_bucket_stage_kernel<true, kMaxVec>
                                     : ordered_bucket_stage_kernel<true, 0>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStageThreads, smem);
  // chunks of axis 0: the fewest steps a block runs one after another
  // (waves x planes a chunk, the halo planes counted), an SM holding per_sm
  // blocks at once
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long best = -1;
  for (int c = 1; c <= n0; ++c) {
    const int chunk = (n0 + c - 1) / c;
    const int chunks = (n0 + chunk - 1) / chunk;
    const long long waves = (static_cast<long long>(tiles) * groups * chunks + slots - 1) / slots;
    const long long cost = waves * (chunk + 2 * r0);
    if (best < 0 || cost < best) {
      best = cost;
      sh.chunk = chunk;
    }
  }
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>((n0 + sh.chunk - 1) / sh.chunk),
                  static_cast<unsigned>(groups));
  const dim3 block(kTile2, kTile1);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(F);
  const auto* x = static_cast<const float*>(X);
  const auto* xa = static_cast<const float*>(Xalt);
  auto* y = static_cast<float*>(Y);
  auto* ya = static_cast<float*>(Yalt);
  const auto* t = static_cast<const int*>(terms);
  const auto* sc = static_cast<const int*>(src);
  kernel<<<grid, block, smem, s>>>(f, x, xa, y, ya, t, sc, sh);
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
// (8, 1, 0) with FMA; the 2-D norms' lanes across the grid's first axis
// (2, 1, 0), (4, 1, 0), (8, 1, 0) in both modes, rows of any length (a
// row past 32 floats is read from global memory, as planes are).  Anything
// else, or another length than at most 32 for the others, returns
// cudaErrorInvalidValue.
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
  if (ic == 1 && evf == 0 && vf == 2)
    return fma ? launch_lanes<2, 1, 0, true>(af, bf, of, rows, len, planes, s)
               : launch_lanes<2, 1, 0, false>(af, bf, of, rows, len, planes, s);
  if (ic == 1 && evf == 0 && vf == 4)
    return fma ? launch_lanes<4, 1, 0, true>(af, bf, of, rows, len, planes, s)
               : launch_lanes<4, 1, 0, false>(af, bf, of, rows, len, planes, s);
  if (ic == 1 && evf == 0 && vf == 8)
    return fma ? launch_lanes<8, 1, 0, true>(af, bf, of, rows, len, planes, s)
               : launch_lanes<8, 1, 0, false>(af, bf, of, rows, len, planes, s);
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
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
