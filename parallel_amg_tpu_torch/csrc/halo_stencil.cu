// Halo stencil matvec on Hopper (sm_90a): one part's share of y = A·x for a
// stencil operator whose grid is split along axis 0 into slabs (kernel B8).
//
// Replaces parallel_amg_tpu/parallel/phalo_async.py::async_halo_matvec (its
// Pallas kernel _halo_matvec_kernel).  That kernel keeps the whole slab in
// VMEM, starts ICI remote DMAs of the h boundary planes to both neighbor
// chips, computes the interior while the DMAs fly, waits on semaphores and
// then adds the boundary corrections.  Here the halo copies run outside the
// kernel, on a copy stream (parallel/phalo_async.py orchestrates: copies
// started, interior kernel, wait on the copies' events, boundary kernel), so
// the kernel is two entry points:
//
// - halo_stencil_interior: y[p] = sum_d W[d, p] * x[p + off_d], reading 0
//   where p + off_d leaves the slab on axis 0 or the grid on another axis.
//   One thread per local point, grid-stride.
// - halo_stencil_boundary: for the points of the first and last h planes
//   (h = max |off_d[0]|), y[p] += W[d, p] * halo for each offset in order:
//   o0 < 0 and i0 < -o0 read left-halo plane h + o0 + i0; o0 > 0 and
//   i0 >= m0 - o0 read right-halo plane i0 + o0 - m0.  A null halo is the
//   zero halo at the grid's end.  One thread per point, so no two threads
//   write one y.
//
// Layout: the slab is (m0, n1, n2) row-major in f32 (a 2-D grid is
// (m0, 1, n2), a 1-D one (m0, 1, 1)); W is (D, m0, n1, n2).  The offsets
// ride in a by-value kernel parameter (at most kMaxPoints), as in B2.
// Products and sums use __fmul_rn/__fadd_rn in offset order, with no FMA
// contraction: y is bit-reproducible and equals the plain torch version's
// sums (parallel/pstencil.py interior_plain, boundary_plain) term for term.
// Plane and element indices are 64-bit: D*m0*n1*n2 passes 2^31 at the
// 102.5M-DOF grid.
//
// What bounds it: device-memory bytes.  W is D*m0*n1*n2*4 bytes read once;
// x is read D times but neighboring threads share it through L1/L2; y is
// written once and the boundary kernel rereads 2h planes of it.

#include <cuda_runtime.h>

constexpr int kMaxPoints = 192;

// Plain-C layout shared with the ctypes wrapper (parallel/phalo_async.py).
struct HaloOffsets {
  int count;
  int o0[kMaxPoints];
  int o1[kMaxPoints];
  int o2[kMaxPoints];
};

namespace {

constexpr int kBlock = 256;
constexpr long long kMaxBlocks = 65535;

__global__ void __launch_bounds__(kBlock)
    interior_kernel(const float* __restrict__ W, const float* __restrict__ x,
                    float* __restrict__ y, long long m0, int n1, int n2,
                    HaloOffsets offs) {
  const long long plane = static_cast<long long>(n1) * n2;
  const long long n = m0 * plane;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long p = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       p < n; p += stride) {
    const long long i0 = p / plane;
    const long long r = p - i0 * plane;
    const int i1 = static_cast<int>(r / n2);
    const int i2 = static_cast<int>(r - static_cast<long long>(i1) * n2);
    float acc = 0.f;
    for (int d = 0; d < offs.count; ++d) {
      const long long j0 = i0 + offs.o0[d];
      const int j1 = i1 + offs.o1[d];
      const int j2 = i2 + offs.o2[d];
      if (j0 < 0 || j0 >= m0 || j1 < 0 || j1 >= n1 || j2 < 0 || j2 >= n2) {
        continue;
      }
      const float xv = __ldg(x + j0 * plane + static_cast<long long>(j1) * n2 + j2);
      acc = __fadd_rn(acc, __fmul_rn(W[d * n + p], xv));
    }
    y[p] = acc;
  }
}

__global__ void __launch_bounds__(kBlock)
    boundary_kernel(const float* __restrict__ W, const float* __restrict__ lh,
                    const float* __restrict__ rh, float* __restrict__ y,
                    long long m0, int n1, int n2, int h, HaloOffsets offs) {
  const long long plane = static_cast<long long>(n1) * n2;
  const long long n = m0 * plane;
  const long long nb = (2LL * h < m0) ? 2LL * h : m0;  // boundary planes
  const long long total = nb * plane;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       t < total; t += stride) {
    const long long k = t / plane;
    const long long r = t - k * plane;
    const long long i0 = (k < h) ? k : m0 - nb + k;
    const int i1 = static_cast<int>(r / n2);
    const int i2 = static_cast<int>(r - static_cast<long long>(i1) * n2);
    const long long p = i0 * plane + r;
    float acc = y[p];
    for (int d = 0; d < offs.count; ++d) {
      const int o0 = offs.o0[d];
      if (o0 == 0) {
        continue;
      }
      const int j1 = i1 + offs.o1[d];
      const int j2 = i2 + offs.o2[d];
      if (j1 < 0 || j1 >= n1 || j2 < 0 || j2 >= n2) {
        continue;
      }
      const long long col = static_cast<long long>(j1) * n2 + j2;
      float hv;
      if (o0 < 0) {
        if (lh == nullptr || i0 >= -o0) {
          continue;
        }
        hv = lh[(h + o0 + i0) * plane + col];
      } else {
        if (rh == nullptr || i0 < m0 - o0) {
          continue;
        }
        hv = rh[(i0 + o0 - m0) * plane + col];
      }
      acc = __fadd_rn(acc, __fmul_rn(W[d * n + p], hv));
    }
    y[p] = acc;
  }
}

unsigned blocks_for(long long work) {
  long long blocks = (work + kBlock - 1) / kBlock;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

bool bad_args(long long m0, int n1, int n2, const HaloOffsets& offs) {
  return offs.count < 0 || offs.count > kMaxPoints || m0 < 0 || n1 <= 0 ||
         n2 <= 0;
}

}  // namespace

// Plain C entry points for ctypes.  Each returns cudaGetLastError() after
// the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int halo_stencil_interior(const void* W, const void* x, void* y,
                                     long long m0, int n1, int n2,
                                     HaloOffsets offs, void* stream) {
  if (bad_args(m0, n1, n2, offs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = m0 * n1 * static_cast<long long>(n2);
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  interior_kernel<<<blocks_for(n), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), m0, n1, n2, offs);
  return static_cast<int>(cudaGetLastError());
}

// lh and rh are (h, n1, n2) halo planes or null (the zero halo).
extern "C" int halo_stencil_boundary(const void* W, const void* lh,
                                     const void* rh, void* y, long long m0,
                                     int n1, int n2, int h, HaloOffsets offs,
                                     void* stream) {
  if (bad_args(m0, n1, n2, offs) || h < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nb = (2LL * h < m0) ? 2LL * h : m0;
  const long long total = nb * n1 * static_cast<long long>(n2);
  if (total == 0) {
    return static_cast<int>(cudaSuccess);
  }
  boundary_kernel<<<blocks_for(total), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(lh),
      static_cast<const float*>(rh), static_cast<float*>(y), m0, n1, n2, h,
      offs);
  return static_cast<int>(cudaGetLastError());
}
