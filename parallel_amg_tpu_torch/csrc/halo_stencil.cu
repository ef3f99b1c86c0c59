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
// own.
//
// The exchange route of parallel/phalo_async.py, where some parts' halos come
// from another card or process, takes two launches a card:
//
// - the interior: halo_stencil_matvec again, over a table in which such a
//   "split" part gets null on both sides, so it gets its interior terms only
//   (a null neighbor is the zero halo); a part whose neighbors are on this
//   card rides in the same launch with its real neighbors and comes out
//   whole.  It runs before the halo exchange is waited for.
// - halo_stencil_boundary: the boundary corrections of every split part on
//   the card, after the exchange.  A part table holds each split part's W
//   and y, its left and right landing buffers, (h, n1, n2) each or null at
//   the grid's ends, and how many planes at the slab's start and end their
//   halo terms reach (none on a null side), so the launch touches only the
//   planes that get a term.  The offsets with o0 != 0 are compacted on the
//   host, in offset order, with the plane of W each one reads, so the kernel
//   never walks the in-plane offsets (most of a 27-point or Galerkin
//   stencil).
//
// ordered_stencil_matvec is not B8 and replaces no Pallas kernel: it is the
// setups' power iteration, y = D^-1 (A x) in the float32 order of the JAX
// package's CPU backend (ops/ordered_stencil.py has the order), for every
// part on the card in one launch, on B8's part table.  It replaces, per
// iteration, the stack of K shifted copies of x, one ordered_sum_lanes
// launch a part (its fma chain) and one ordered_fma launch a part and
// offset with o0 != 0 (its halo updates), and the D^-1 multiply.  Per point:
// acc = +0.0, then acc = fma(W[d][p], x[p + off_d], acc) over the chain's
// planes in the JAX package's order, x read as 0 off the slab on axis 0 or
// off the grid on the other axes (that zero term is kept: it turns a -0
// into +0); at a split position (a 7-point grid or part LLVM vectorises
// across i1, or a 2-D grid, seen as (1, n0, n1), across i0) the product is
// rounded and added on the rows i1 < rows that its vector loop covers,
// fused on the rest; on a 2-D grid's columns i2 >= swap (the scalar last
// column of a 9-point grid 9 columns wide) the chain's first two planes
// are taken the other way round.  Then, where the grid is split
// into parts, each offset with o0 != 0 in offset order adds fma(W[d][p], halo,
// acc) on the |o0| planes at the slab's end it reaches past, from the
// neighbor's (h, n1, n2) halo (a view of its slab on this card, or a landing
// buffer), 0 at the grid's ends.  Then y = D^-1 * acc, one rounded multiply.
// Its grid is (groups of V points of a part, part), flat over the part, so
// a one-device grid of any m0 fits; the terms are a HaloTerms table, chain
// first.  Bound: device-memory bytes, W, D^-1 and y once and x once (its
// neighbors' reads hit L1/L2): (K + 3) x n x 4 bytes a part.
//
// Grids: (tile of the (n1, n2) plane, plane, part).  The boundary's plane k
// of a part that reaches lo planes at the start and hi at the end maps to
// i0 = k for k < lo, else i0 = m0 - lo - hi + k (the host takes lo = m0,
// hi = 0 where the two overlap, so no plane is counted twice); the grid's
// plane extent is the largest lo + hi of the table, and a part's blocks past
// its own return at once.  A thread finds its point with one 32-bit division
// within a plane.  Each thread owns V consecutive points of a row (V = 4
// where n2 % 4 == 0 and the pointers of W and y are 16-byte aligned, else
// 1): 16-byte streaming loads of W, 16-byte stores of y (the boundary reads
// and writes y back 16 bytes at a time).
//
// Terms: first the interior terms, y[p] = sum_d W[d, p] * x[p + off_d] over
// the offsets whose target stays inside the slab (reading nothing outside
// the grid on the other axes), in offset order; then, on the first and last
// h planes (h = max |off_d[0]|), the halo terms in offset order: o0 < 0 and
// i0 < -o0 read the left neighbor's plane m0 + i0 + o0 (its landing buffer's
// plane h + i0 + o0); o0 > 0 and i0 >= m0 - o0 read the right neighbor's
// plane i0 + o0 - m0.  The boundary entry starts from acc = y[p] and adds the
// same halo terms in the same order.  Products and sums use
// __fmul_rn/__fadd_rn, with no FMA contraction: y is bit-reproducible, equals
// the plain torch version's sums (parallel/pstencil.py interior_plain, then
// boundary_plain) term for term, and the route equals the one-launch entry
// bit for bit.
//
// Layout: the slab is (m0, n1, n2) row-major in f32 (a 2-D grid is
// (m0, 1, n2), a 1-D one (m0, 1, 1)); W is (D, m0, n1, n2).  The offsets
// ride in by-value kernel parameters (at most kMaxPoints), as in B2.
// Element indices are 64-bit where they can pass 2^31: D*m0*n1*n2 does at
// the 102.5M-DOF grid.
//
// What bounds it: device-memory bytes for the matvec and the interior.
// W is D of the D + 2 arrays and is read once, streamed (evict-first) in
// 128-bit loads along n2; x goes through the read-only path and its D reads
// of each value hit L1/L2; y is written once.  The boundary entry moves the
// h planes of y on each side that has a neighbor, the halo terms' planes of
// W and the landing buffers: a few hundred kB at config #3's level 0, so one
// launch's latency bounds it; one launch a card for every split part, no
// walk over the in-plane offsets, no plane without a halo term.

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

// The offsets with o0 != 0, in offset order, and the plane d of W each reads.
struct HaloTerms {
  int count;
  int d[kMaxPoints];
  int o0[kMaxPoints];
  int o1[kMaxPoints];
  int o2[kMaxPoints];
};

// The parts of one matvec or interior launch: each one's (D, m0, n1, n2)
// weights, (m0, n1, n2) x and y, and the x slabs of its axis-0 neighbors
// (null at the grid's ends, and on both sides of a split part).
// ordered_stencil_matvec reads left and right as the (h, n1, n2) halos
// themselves (the last h planes of the left neighbor, the first h of the
// right one: views of its slab on this card, or landing buffers), and scale
// as each part's (m0, n1, n2) D^-1 (null: no scaling); the B8 entries ignore
// scale.
struct HaloParts {
  int count;
  const float* W[kMaxParts];
  const float* x[kMaxParts];
  float* y[kMaxParts];
  const float* left[kMaxParts];
  const float* right[kMaxParts];
  const float* scale[kMaxParts];
};

// The split parts of one boundary launch: each one's weights and y, its
// (h, n1, n2) left and right landing buffers (null at the grid's ends), and
// the planes its halo terms reach: lo at the slab's start, hi at its end
// (lo + hi <= m0; 0 on a null side).
struct HaloBoundary {
  int count;
  const float* W[kMaxParts];
  float* y[kMaxParts];
  const float* left[kMaxParts];
  const float* right[kMaxParts];
  int lo[kMaxParts];
  int hi[kMaxParts];
};

namespace {

constexpr int kBlock = 256;

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
__device__ __forceinline__ void store(float* y, const float (&acc)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(y) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *y = acc[0];
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
  const float* __restrict__ lx = parts.left[part];
  const float* __restrict__ rx = parts.right[part];
  if ((lx != nullptr || rx != nullptr) && (i0 < h || i0 >= m0 - h)) {
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
  store<V>(parts.y[part] + static_cast<long long>(i0) * plane + q, acc);
}

template <int V>
__global__ void __launch_bounds__(kBlock)
    boundary_kernel(HaloBoundary parts, HaloTerms terms, int m0, int n1, int n2,
                    int h) {
  const int part = blockIdx.z;
  const int k = blockIdx.y;
  const int lo = parts.lo[part];
  const int planes = lo + parts.hi[part];
  if (k >= planes) {
    return;
  }
  const int i0 = k < lo ? k : m0 - planes + k;
  const int plane = n1 * n2;
  const int q = (static_cast<int>(blockIdx.x) * kBlock + threadIdx.x) * V;
  if (q >= plane) {
    return;
  }
  const int i1 = q / n2;
  const int i2 = q - i1 * n2;
  const long long n = static_cast<long long>(m0) * plane;
  const long long at = static_cast<long long>(i0) * plane + q;
  const float* __restrict__ w0 = parts.W[part] + at;
  const float* __restrict__ lh = parts.left[part];
  const float* __restrict__ rh = parts.right[part];
  float* y = parts.y[part] + at;
  float acc[V];
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(y);
    acc[0] = t.x;
    acc[1] = t.y;
    acc[2] = t.z;
    acc[3] = t.w;
  } else {
    acc[0] = *y;
  }
  for (int t = 0; t < terms.count; ++t) {
    const int o0 = terms.o0[t];
    const int j1 = i1 + terms.o1[t];
    const float* src;
    if (o0 < 0) {
      if (lh == nullptr || i0 >= -o0) {
        continue;
      }
      src = lh + static_cast<long long>(h + o0 + i0) * plane;
    } else {
      if (rh == nullptr || i0 < m0 - o0) {
        continue;
      }
      src = rh + static_cast<long long>(i0 + o0 - m0) * plane;
    }
    if (j1 < 0 || j1 >= n1) {
      continue;
    }
    add_terms<V>(acc, w0 + terms.d[t] * n, src + static_cast<long long>(j1) * n2,
                 i2 + terms.o2[t], n2);
  }
  store<V>(y, acc);
}

// acc[v] = fma(w[v], x, acc[v]) for V consecutive points, x read at column
// j2 + v of the row xr, 0 where xr is null or the column lies off [0, n2):
// the zero term is kept, as it turns an acc of -0 into +0.  With unfused,
// the product is rounded and then added (LLVM's vectorised centre).
template <int V>
__device__ __forceinline__ void ordered_term(float (&acc)[V],
                                             const float* __restrict__ w,
                                             const float* __restrict__ xr,
                                             int j2, int n2, bool unfused) {
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
    const float xv = (xr != nullptr && j >= 0 && j < n2) ? __ldg(xr + j) : 0.f;
    acc[v] = unfused ? __fadd_rn(acc[v], __fmul_rn(wv[v], xv))
                     : __fmaf_rn(wv[v], xv, acc[v]);
  }
}

// One thread a group of V points of one part (grid: (point groups, part)):
// the chain terms, then the halo terms on the planes they reach, then D^-1.
template <int V>
__global__ void __launch_bounds__(kBlock)
    ordered_kernel(HaloParts parts, HaloTerms terms, int chain, int split,
                   int rows, int swap, int m0, int n1, int n2, int h) {
  const int part = blockIdx.y;
  const int plane = n1 * n2;
  const long long n = static_cast<long long>(m0) * plane;
  const long long q =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) * V;
  if (q >= n) {
    return;
  }
  const int i0 = static_cast<int>(q / plane);
  const int r = static_cast<int>(q - static_cast<long long>(i0) * plane);
  const int i1 = r / n2;
  const int i2 = r - i1 * n2;
  const float* __restrict__ w0 = parts.W[part] + q;
  const float* __restrict__ x = parts.x[part];
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[v] = 0.f;
  }
  // the chain: every plane in the JAX package's order, 0 off the slab; the
  // centre unfused on rows i1 < rows (a thread's V points share one row)
  const int unfused = i1 < rows ? split : -1;
  // from column `swap` on (V = 1 there) the chain's first two terms are
  // taken the other way round (a 2-D grid's scalar last column)
  const bool swapped = i2 >= swap;
  for (int u = 0; u < chain; ++u) {
    const int t = swapped && u < 2 ? 1 - u : u;
    const int j0 = i0 + terms.o0[t];
    const int j1 = i1 + terms.o1[t];
    const float* xr = (j0 >= 0 && j0 < m0 && j1 >= 0 && j1 < n1)
                          ? x + static_cast<long long>(j0) * plane +
                                static_cast<long long>(j1) * n2
                          : nullptr;
    ordered_term<V>(acc, w0 + terms.d[t] * n, xr, i2 + terms.o2[t], n2,
                    t == unfused);
  }
  // the halo terms, in offset order, on the |o0| planes at the slab's end
  // each reaches past (a zero plane where there is no neighbor)
  if (chain < terms.count && (i0 < h || i0 >= m0 - h)) {
    const float* __restrict__ lh = parts.left[part];
    const float* __restrict__ rh = parts.right[part];
    for (int t = chain; t < terms.count; ++t) {
      const int o0 = terms.o0[t];
      const float* src;
      if (o0 < 0) {
        if (i0 >= -o0) {
          continue;
        }
        src = lh == nullptr ? nullptr
                            : lh + static_cast<long long>(h + i0 + o0) * plane;
      } else {
        if (i0 < m0 - o0) {
          continue;
        }
        src = rh == nullptr ? nullptr
                            : rh + static_cast<long long>(i0 + o0 - m0) * plane;
      }
      const int j1 = i1 + terms.o1[t];
      src = (src == nullptr || j1 < 0 || j1 >= n1)
                ? nullptr
                : src + static_cast<long long>(j1) * n2;
      ordered_term<V>(acc, w0 + terms.d[t] * n, src, i2 + terms.o2[t], n2,
                      false);
    }
  }
  const float* __restrict__ s = parts.scale[part];
  if (s != nullptr) {
    float sv[V];
    if constexpr (V == 4) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(s + q));
      sv[0] = t.x;
      sv[1] = t.y;
      sv[2] = t.z;
      sv[3] = t.w;
    } else {
      sv[0] = __ldcs(s + q);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] = __fmul_rn(sv[v], acc[v]);
    }
  }
  store<V>(parts.y[part] + q, acc);
}

// The checks every entry shares: the plane's index math is 32-bit, the
// grid's y extent holds the planes and its z extent the parts.
bool bad_grid(int count, int m0, int n1, int n2, int h, int vec) {
  return count < 0 || count > kMaxParts || m0 < 0 || m0 > 65535 || n1 <= 0 ||
         n2 <= 0 || static_cast<long long>(n1) * n2 >= (1LL << 31) || h < 0 ||
         (m0 > 0 && h >= m0) || (vec != 0 && n2 % 4 != 0);
}

dim3 grid_for(int count, int planes, int n1, int n2, int vec) {
  const int per = vec != 0 ? 4 : 1;
  const int groups = (n1 * n2 + per - 1) / per;
  return dim3((groups + kBlock - 1) / kBlock, planes, count);
}

}  // namespace

// Plain C entry points for ctypes.  Each returns cudaGetLastError() after
// the launch (0 on success); the launch is asynchronous on `stream`.  vec 1
// takes four points a thread (the caller checks n2 % 4 == 0 and 16-byte
// aligned W and y pointers), vec 0 one.

// parts.count parts of m0 planes each on this card in one launch: whole, or
// (the exchange route's interior) a part with null neighbors on both sides
// its interior terms only.
extern "C" int halo_stencil_matvec(HaloParts parts, int m0, int n1, int n2,
                                   int h, HaloOffsets offs, int vec,
                                   void* stream) {
  if (bad_grid(parts.count, m0, n1, n2, h, vec) || offs.count < 0 ||
      offs.count > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (parts.count == 0 || m0 == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(parts.count, m0, n1, n2, vec);
  if (vec != 0) {
    matvec_kernel<4><<<grid, kBlock, 0, cs>>>(parts, offs, m0, n1, n2, h);
  } else {
    matvec_kernel<1><<<grid, kBlock, 0, cs>>>(parts, offs, m0, n1, n2, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// The exchange route's second launch: every split part's halo terms added to
// its y in place, from (h, n1, n2) landing buffers or null (the zero halo),
// on the lo + hi planes of each part that they reach.
extern "C" int halo_stencil_boundary(HaloBoundary parts, int m0, int n1,
                                     int n2, int h, HaloTerms terms, int vec,
                                     void* stream) {
  if (bad_grid(parts.count, m0, n1, n2, h, vec) || terms.count < 0 ||
      terms.count > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int planes = 0;
  for (int i = 0; i < parts.count; ++i) {
    const int lo = parts.lo[i], hi = parts.hi[i];
    if (lo < 0 || hi < 0 || lo + hi > m0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    planes = lo + hi > planes ? lo + hi : planes;
  }
  if (planes == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(parts.count, planes, n1, n2, vec);
  if (vec != 0) {
    boundary_kernel<4><<<grid, kBlock, 0, cs>>>(parts, terms, m0, n1, n2, h);
  } else {
    boundary_kernel<1><<<grid, kBlock, 0, cs>>>(parts, terms, m0, n1, n2, h);
  }
  return static_cast<int>(cudaGetLastError());
}

// The power iterations' y = D^-1 (A x) of every part in the table, in one
// launch: terms[0, chain) are the chain in its order (split: the position
// whose product is added rounded on the rows i1 < rows, fused on the rest;
// -1 for none; on the columns i2 >= swap the first two terms the other way
// round, n2 for none, which vec needs), terms[chain, count) the halo terms
// (o0 != 0, offset order; none for a grid that is not split); left and
// right are (h, n1, n2) halos or null, h <= m0.
extern "C" int ordered_stencil_matvec(HaloParts parts, int m0, int n1, int n2,
                                      int h, HaloTerms terms, int chain,
                                      int split, int rows, int swap, int vec,
                                      void* stream) {
  if (parts.count < 0 || parts.count > kMaxParts || m0 < 0 || n1 <= 0 ||
      n2 <= 0 || static_cast<long long>(n1) * n2 >= (1LL << 31) || h < 0 ||
      (m0 > 0 && h > m0) || (vec != 0 && n2 % 4 != 0) || terms.count < 0 ||
      terms.count > kMaxPoints || chain < 0 || chain > terms.count ||
      split < -1 || split >= chain || rows < 0 || rows > n1 || swap < 0 ||
      swap > n2 || (swap < n2 && (vec != 0 || chain < 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (parts.count == 0 || m0 == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const int per = vec != 0 ? 4 : 1;
  const long long groups = (static_cast<long long>(m0) * n1 * n2) / per;
  const dim3 grid(static_cast<unsigned>((groups + kBlock - 1) / kBlock),
                  parts.count);
  if (vec != 0) {
    ordered_kernel<4><<<grid, kBlock, 0, cs>>>(parts, terms, chain, split,
                                               rows, swap, m0, n1, n2, h);
  } else {
    ordered_kernel<1><<<grid, kBlock, 0, cs>>>(parts, terms, chain, split,
                                               rows, swap, m0, n1, n2, h);
  }
  return static_cast<int>(cudaGetLastError());
}
