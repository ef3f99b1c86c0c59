// Float32 row sums in a fixed order: the order the JAX package's CPU backend
// adds them (ops/ordered_sum.py has the rule).
//
// x is (rows, d1, d2), row-major and contiguous.  Each reduced axis is cut
// into n windows of w elements with lo elements of zero padding before the
// first (n = 1, w = d, lo = 0 for an axis of 32 or fewer).  out is
// (rows, n1, n2): out[r, a, b] is the sum of window (a, b) of row r, added
// from +0.0 one element at a time in row-major order within the window,
// padding skipped.  A sum over windows is the same kernel run again on out.
//
// With vf > 0 the kernel adds one row of at most 32 in the order of LLVM's
// vectorised reduction loop instead (ops/ordered_sum.py: lanes=(vf, ic, evf)):
// ic accumulators of vf lanes over whole blocks of vf·ic elements, added
// lanewise, halved; then blocks of evf lanes starting from that sum; then
// the rest one at a time.
//
// One thread per output.  Every add is __fadd_rn (no contraction, no
// reassociation: the file is built without fast math), so the result is the
// plain version's bit for bit.  Where one window is the whole row and a row
// holds at most kMaxStagedRow floats, the block first copies its
// rows (one contiguous span of x) to shared memory with coalesced loads, at
// an odd row stride so that the threads' reads fall in distinct banks.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStagedRow = 64;  // floats of one row staged in shared memory

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

__global__ void __launch_bounds__(kBlock)
ordered_sum_windows(const float* __restrict__ x, float* __restrict__ out,
                    long long n_out, int d1, int d2, int w1, int w2, int n1,
                    int n2, int lo1, int lo2) {
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= n_out) return;
  const int per_row = n1 * n2;
  const long long r = t / per_row;
  const int win = static_cast<int>(t - r * per_row);
  const int a = win / n2, b = win - a * n2;
  const int i0 = a * w1 - lo1, j0 = b * w2 - lo2;
  const int ib = max(i0, 0), ie = min(i0 + w1, d1);
  const int jb = max(j0, 0), je = min(j0 + w2, d2);
  const float* row = x + r * d1 * static_cast<long long>(d2);
  float acc = 0.0f;
  for (int i = ib; i < ie; ++i)
    for (int j = jb; j < je; ++j) acc = __fadd_rn(acc, row[i * d2 + j]);
  out[t] = acc;
}

// LLVM's reduction of n lanes (a power of 2): lane l += lane l + n/2, ...
__device__ float halving(float* v, int n) {
  for (int h = n / 2; h >= 1; h /= 2)
    for (int l = 0; l < h; ++l) v[l] = __fadd_rn(v[l], v[l + h]);
  return v[0];
}

__global__ void __launch_bounds__(kBlock)
ordered_sum_lanes(const float* __restrict__ x, float* __restrict__ out,
                  long long rows, int len, int vf, int ic, int evf) {
  const long long r = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= rows) return;
  const float* row = x + r * len;
  float acc[32], lanes[32];
  const int step = vf * ic;
  int j = len / step * step;
  float s = 0.0f;
  if (j > 0) {
    for (int k = 0; k < step; ++k) acc[k] = 0.0f;
    for (int b = 0; b < j; b += step)
      for (int k = 0; k < step; ++k) acc[k] = __fadd_rn(acc[k], row[b + k]);
    for (int p = 1; p < ic; ++p)
      for (int l = 0; l < vf; ++l) acc[l] = __fadd_rn(acc[l], acc[p * vf + l]);
    s = halving(acc, vf);
  }
  if (evf > 0 && len - j >= evf) {
    lanes[0] = s;
    for (int l = 1; l < evf; ++l) lanes[l] = 0.0f;
    const int end = j + (len - j) / evf * evf;
    for (; j < end; j += evf)
      for (int l = 0; l < evf; ++l) lanes[l] = __fadd_rn(lanes[l], row[j + l]);
    s = halving(lanes, evf);
  }
  for (; j < len; ++j) s = __fadd_rn(s, row[j]);
  out[r] = s;
}

}  // namespace

// One level of windows of (rows, d1, d2) float32 x into (rows, n1, n2) out,
// on `stream`; with vf > 0, one window per row in LLVM's vectorised order.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ordered_sum(const void* x, void* out, long long rows, int d1,
                           int d2, int w1, int w2, int n1, int n2, int lo1,
                           int lo2, int vf, int ic, int evf, void* stream) {
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const long long n_out = rows * n1 * static_cast<long long>(n2);
  if (n_out == 0) return 0;
  const long long blocks = (n_out + kBlock - 1) / kBlock;
  const int len = d1 * d2;
  if (vf > 0) {
    if (n1 != 1 || n2 != 1 || len > 32 || vf * ic > 32 || evf > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    ordered_sum_lanes<<<static_cast<unsigned>(blocks), kBlock, 0, cs>>>(
        xf, of, rows, len, vf, ic, evf);
  } else if (n1 == 1 && n2 == 1 && len > 0 && len <= kMaxStagedRow) {
    const size_t smem = sizeof(float) * kBlock * (len | 1);
    ordered_sum_staged<<<static_cast<unsigned>(blocks), kBlock, smem, cs>>>(
        xf, of, rows, len);
  } else {
    ordered_sum_windows<<<static_cast<unsigned>(blocks), kBlock, 0, cs>>>(
        xf, of, n_out, d1, d2, w1, w2, n1, n2, lo1, lo2);
  }
  return static_cast<int>(cudaGetLastError());
}
