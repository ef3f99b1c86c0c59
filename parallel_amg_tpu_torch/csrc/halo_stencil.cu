// Halo stencil matvec on Hopper (sm_90a): y = A·x for a stencil operator
// whose grid is split along axis 0 into slabs of m0 planes, one per part
// (kernel B8).
//
// Replaces parallel_amg_tpu/parallel/phalo_async.py::async_halo_matvec (its
// Pallas kernel _halo_matvec_kernel).  That kernel keeps the whole slab in
// VMEM, starts ICI remote DMAs of the h boundary planes to both neighbor
// chips, computes the interior while the DMAs fly, waits on semaphores and
// then adds the boundary corrections.
//
// halo_stencil_matvec: every part that lies on one card, in one launch.  A
// part table passed by value holds each part's W, x and y and its left and
// right neighbors' slabs (null at the grid's ends).  A neighbor's boundary
// planes are already in this card's memory, so the halo terms read them in
// place: no landing buffers, copies, streams or events.  That is what the
// TPU kernel's remote DMA becomes when the neighbor's memory is the card's
// own.  Grid: (tile of the (n1, n2) plane, plane i0, part), so a thread finds
// its point with one 32-bit division, not a 64-bit one per point.
// Each thread owns V consecutive points of a row (V = 4 where n2 % 4 == 0 and
// the pointers are 16-byte aligned, else 1).
//
// halo_stencil_interior / halo_stencil_boundary: one part's interior (zero
// halo) and its boundary corrections from landing buffers, for parts on
// several cards, where parallel/phalo_async.py copies the halo planes on a
// copy stream between the two launches.
//
// Terms, in every entry: first the interior terms, y[p] = sum_d W[d, p] *
// x[p + off_d] over the offsets whose target stays inside the slab (reading
// nothing outside the grid on the other axes), in offset order; then, on the
// first and last h planes (h = max |off_d[0]|), the halo terms in offset
// order: o0 < 0 and i0 < -o0 read the left neighbor's plane m0 + i0 + o0 (its
// landing buffer's plane h + i0 + o0); o0 > 0 and i0 >= m0 - o0 read the right
// neighbor's plane i0 + o0 - m0.  A null neighbor is the zero halo.  Products
// and sums use __fmul_rn/__fadd_rn, with no FMA contraction: y is
// bit-reproducible and equals the plain torch version's sums
// (parallel/pstencil.py interior_plain, boundary_plain) term for term, and
// the one-launch entry equals the two-launch pair bit for bit.
//
// Layout: the slab is (m0, n1, n2) row-major in f32 (a 2-D grid is
// (m0, 1, n2), a 1-D one (m0, 1, 1)); W is (D, m0, n1, n2).  The offsets
// ride in a by-value kernel parameter (at most kMaxPoints), as in B2.
// Element indices are 64-bit where they can pass 2^31: D*m0*n1*n2 does at
// the 102.5M-DOF grid.
//
// What bounds it: device-memory bytes.  W is D of the D + 2 arrays and is
// read once, streamed (evict-first) in 128-bit loads along n2; x goes
// through the read-only path and its D reads of each value hit L1/L2; y is
// written once, with no second pass over it in the one-launch entry (the
// two-launch pair rereads 2h planes of it).

#include <cuda_runtime.h>

constexpr int kMaxPoints = 192;
constexpr int kMaxParts = 16;

// Plain-C layouts shared with the ctypes wrapper (parallel/phalo_async.py).
struct HaloOffsets {
  int count;
  int o0[kMaxPoints];
  int o1[kMaxPoints];
  int o2[kMaxPoints];
};

// The parts of one launch: each one's (D, m0, n1, n2) weights, (m0, n1, n2)
// x and y, and the x slabs of its axis-0 neighbors (null at the grid's ends).
struct HaloParts {
  int count;
  const float* W[kMaxParts];
  const float* x[kMaxParts];
  float* y[kMaxParts];
  const float* left[kMaxParts];
  const float* right[kMaxParts];
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

// acc[v] += w[v] * xr[j2 + v] for the points whose column j2 + v lies in
// [0, n2); w points at V consecutive weights of one offset, read once.
template <int V>
__device__ __forceinline__ void add_terms(float (&acc)[V],
                                          const float* __restrict__ w,
                                          const float* __restrict__ xr, int j2,
                                          int n2) {
  float wv[V];
  if constexpr (V == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(w));
    wv[0] = t.x;
    wv[1] = t.y;
    wv[2] = t.z;
    wv[3] = t.w;
  } else {
    wv[0] = __ldcs(w);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = j2 + v;
    if (j >= 0 && j < n2) {
      acc[v] = __fadd_rn(acc[v], __fmul_rn(wv[v], __ldg(xr + j)));
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kBlock)
    matvec_kernel(HaloParts parts, HaloOffsets offs, int m0, int n1, int n2,
                  int h) {
  const int part = blockIdx.z;
  const int i0 = blockIdx.y;
  const int plane = n1 * n2;
  const int q = (static_cast<int>(blockIdx.x) * kBlock + threadIdx.x) * V;
  if (q >= plane) {
    return;
  }
  const int i1 = q / n2;
  const int i2 = q - i1 * n2;
  const long long n = static_cast<long long>(m0) * plane;
  const float* __restrict__ w0 =
      parts.W[part] + static_cast<long long>(i0) * plane + q;
  const float* __restrict__ x = parts.x[part];
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[v] = 0.f;
  }
  // interior terms: targets inside the slab, in offset order
#pragma unroll 4
  for (int d = 0; d < offs.count; ++d) {
    const int j0 = i0 + offs.o0[d];
    const int j1 = i1 + offs.o1[d];
    if (j0 < 0 || j0 >= m0 || j1 < 0 || j1 >= n1) {
      continue;
    }
    add_terms<V>(acc, w0 + d * n,
                 x + static_cast<long long>(j0) * plane +
                     static_cast<long long>(j1) * n2,
                 i2 + offs.o2[d], n2);
  }
  // halo terms of the first and last h planes, read in the neighbors' slabs
  if (i0 < h || i0 >= m0 - h) {
    const float* __restrict__ lx = parts.left[part];
    const float* __restrict__ rx = parts.right[part];
    for (int d = 0; d < offs.count; ++d) {
      const int j0 = i0 + offs.o0[d];
      const int j1 = i1 + offs.o1[d];
      const float* src;
      if (j0 < 0) {
        src = lx == nullptr ? nullptr : lx + static_cast<long long>(j0 + m0) * plane;
      } else if (j0 >= m0) {
        src = rx == nullptr ? nullptr : rx + static_cast<long long>(j0 - m0) * plane;
      } else {
        continue;
      }
      if (src == nullptr || j1 < 0 || j1 >= n1) {
        continue;
      }
      add_terms<V>(acc, w0 + d * n, src + static_cast<long long>(j1) * n2,
                   i2 + offs.o2[d], n2);
    }
  }
  float* y = parts.y[part] + static_cast<long long>(i0) * plane + q;
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(y) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *y = acc[0];
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

// parts.count parts of m0 planes each on this card, in one launch; vec 1
// takes four points a thread (the caller checks n2 % 4 == 0 and 16-byte
// aligned W, x and y), vec 0 one.
extern "C" int halo_stencil_matvec(HaloParts parts, int m0, int n1, int n2,
                                   int h, HaloOffsets offs, int vec,
                                   void* stream) {
  if (bad_args(m0, n1, n2, offs) || h < 0 || h >= m0 || parts.count < 0 ||
      parts.count > kMaxParts || m0 > 65535 ||
      static_cast<long long>(n1) * n2 >= (1LL << 31) ||
      (vec != 0 && n2 % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int plane = n1 * n2;
  if (parts.count == 0 || m0 == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const int per = vec != 0 ? 4 : 1;
  const int groups = (plane + per - 1) / per;
  const dim3 grid((groups + kBlock - 1) / kBlock, m0, parts.count);
  if (vec != 0) {
    matvec_kernel<4><<<grid, kBlock, 0, cs>>>(parts, offs, m0, n1, n2, h);
  } else {
    matvec_kernel<1><<<grid, kBlock, 0, cs>>>(parts, offs, m0, n1, n2, h);
  }
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
