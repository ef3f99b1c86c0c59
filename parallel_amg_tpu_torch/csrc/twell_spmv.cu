// TWELL SpMV on Hopper (sm_90a): y = A·x for an arbitrary rectangular
// sparsity, stored as CSR with int32 row pointers and column indices and f32
// or bf16 values; x and y are f32 and every sum is taken in f32.
//
// Replaces parallel_amg_tpu/ops/twell.py::TWELL.matvec.  That Pallas kernel
// lays the matrix out in 128-lane column windows with sublane-replicated x
// and scalar-prefetched piece tables, because Mosaic can only gather inside
// one vector tile.  A Hopper thread loads any address, so none of that
// carries over: the kernel reads plain CSR.
//
// What bounds it: device-memory bytes.  Each nonzero costs 4 bytes of index
// plus 4 (f32) or 2 (bf16) bytes of value, plus the x gather; at config #2's
// level 1 x is 1.5 MB and stays in the 50 MB L2, so the stream of index and
// value words is the traffic that counts.  On the coarse levels (a few
// thousand rows and fewer) a launch does too little work to fill the card
// and launch latency bounds it instead.
//
// Design: an nnz-blocked CSR stream.  A row-block plan, built once per
// matrix (ops/twell.py::row_blocks), cuts the rows into blocks of
// consecutive rows whose entries fit kCap products (and at most a few
// thousand rows); a row longer than the plan's long-row length forms a
// block of its own.  One thread block per plan block:
// - Stream path (the block's entries fit kCap): the block's threads load
//   its whole entry range [indptr[r0], indptr[r1]) together, 16-byte
//   loads of four indices and four values where aligned, two such loads
//   per thread in flight, gather x through the read-only path and write
//   each product to shared memory.  After one barrier each row is summed
//   from shared memory by a group of G threads, G a power of two ≤ 32 set
//   by the block's mean row length: G = 1 (one thread, ascending entry
//   order) for short rows; lane l of a longer row's group sums entries l,
//   l + G, ... and the group reduces in a fixed shuffle tree.  The groups
//   walk the block's rows in turn.
// - Long-row path (more than kCap entries): the whole block streams the
//   row, each thread summing its share in a fixed order, then a fixed tree
//   over the warps.
// Why blocks of entries and not a thread group per row: on ragged rows such
// groups leave lanes idle on short rows and take a second pass on long
// ones, each group walks a dependent chain (indptr, then indices and
// values, then x) with one load pair a lane in flight, and every row pays a
// shuffle tree.  Here the loads follow entries, not rows, every thread has
// eight index and value words in flight before its first gather, and a
// short row is summed by one thread with no shuffle.
// - No atomics and a fixed summation order (G is a function of the plan):
//   y is bit-reproducible from call to call, so PCG iteration counts do not
//   wobble.  Empty rows store 0; n_cols may differ from n_rows (P and R).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kCap = 4096;  // products a stream block holds in shared memory
constexpr int kUnroll = 2;  // 4-entry loads a thread has in flight
constexpr unsigned kFull = 0xffffffffu;

// Four values in one load: 16 bytes of f32, 8 bytes of bf16.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
  __device__ static void unpack(float4 v, float out[4]) {
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Quad<__nv_bfloat16> {
  using type = uint2;
  __device__ static void unpack(uint2 v, float out[4]) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The products of entries a0 + 4·q + k (k < 4) for the kUnroll quads
// q = q0 + u·kBlock; entries outside [e0, e1) give 0.  a0 is a multiple of
// 4, so with `quads` (the index and value pointers 16- and 8-byte aligned)
// every whole quad is one vector load.  Unsigned entry numbers: a quad may
// start up to 4·kBlock·kUnroll past an end just below 2^31.
template <typename T>
__device__ __forceinline__ void products(const int* __restrict__ indices,
                                         const T* __restrict__ vals,
                                         const float* __restrict__ x,
                                         unsigned a0, unsigned e0, unsigned e1,
                                         bool quads, int q0,
                                         float p[kUnroll][4]) {
  int c[kUnroll][4];
  float w[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned e = a0 + 4u * static_cast<unsigned>(q0 + u * kBlock);
    if (quads && e >= e0 && e + 4 <= e1) {
      const int4 ci = __ldg(reinterpret_cast<const int4*>(indices + e));
      Quad<T>::unpack(__ldg(reinterpret_cast<const typename Quad<T>::type*>(vals + e)),
                      w[u]);
      c[u][0] = ci.x;
      c[u][1] = ci.y;
      c[u][2] = ci.z;
      c[u][3] = ci.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = e + k >= e0 && e + k < e1;
        c[u][k] = in ? __ldg(indices + e + k) : -1;
        w[u][k] = in ? to_float(vals[e + k]) : 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[u][k] = c[u][k] >= 0 ? w[u][k] * __ldg(x + c[u][k]) : 0.f;
    }
  }
}

// A row of more than kCap entries: every thread sums its quads in a fixed
// order, then the warps' sums meet in a fixed tree.
template <typename T>
__device__ void long_row(const int* __restrict__ indices,
                         const T* __restrict__ vals,
                         const float* __restrict__ x, unsigned e0, unsigned e1,
                         bool quads, float* __restrict__ y_row,
                         float* warp_sums) {
  const unsigned a0 = e0 & ~3u;
  const int n_quads = static_cast<int>((e1 - a0 + 3) / 4);
  float sum = 0.f;
  for (int q = threadIdx.x; q < n_quads; q += kUnroll * kBlock) {
    float p[kUnroll][4];
    products<T>(indices, vals, x, a0, e0, e1, quads, q, p);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sum += p[u][k];
      }
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum += __shfl_down_sync(kFull, sum, offset);
  }
  if ((threadIdx.x & 31) == 0) {
    warp_sums[threadIdx.x >> 5] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      total += warp_sums[i];
    }
    *y_row = total;
  }
  __syncthreads();  // warp_sums is reused by the next row
}

// One thread block per plan block [blocks[b], blocks[b + 1]).
template <typename T>
__global__ void __launch_bounds__(kBlock)
    twell_stream_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ indices,
                        const T* __restrict__ vals, const float* __restrict__ x,
                        float* __restrict__ y, const int* __restrict__ blocks,
                        bool quads) {
  // the quads' products at their offset from a0; a0 ≤ e0 < a0 + 4
  __shared__ __align__(16) float prod[kCap + 8];
  __shared__ float warp_sums[kWarps];
  const int r0 = blocks[blockIdx.x];
  const int r1 = blocks[blockIdx.x + 1];
  const unsigned e0 = static_cast<unsigned>(indptr[r0]);
  const unsigned e1 = static_cast<unsigned>(indptr[r1]);
  if (e1 - e0 > static_cast<unsigned>(kCap)) {
    for (int r = r0; r < r1; ++r) {
      long_row<T>(indices, vals, x, static_cast<unsigned>(indptr[r]),
                  static_cast<unsigned>(indptr[r + 1]), quads, y + r,
                  warp_sums);
    }
    return;
  }
  const unsigned a0 = e0 & ~3u;
  const int n_quads = static_cast<int>((e1 - a0 + 3) / 4);
  for (int q = threadIdx.x; q < n_quads; q += kUnroll * kBlock) {
    float p[kUnroll][4];
    products<T>(indices, vals, x, a0, e0, e1, quads, q, p);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int at = 4 * (q + u * kBlock);
      if (at < n_quads * 4) {
        *reinterpret_cast<float4*>(prod + at) =
            make_float4(p[u][0], p[u][1], p[u][2], p[u][3]);
      }
    }
  }
  __syncthreads();
  const int n_rows = r1 - r0;
  const unsigned mean = (e1 - e0) / static_cast<unsigned>(n_rows);
  int g = 1;  // threads per row: one while rows average ≤ 16 entries
  while (g < 32 && 16u * g < mean) {
    g *= 2;
  }
  const int lane = threadIdx.x & (g - 1);
  const int group = threadIdx.x / g;
  const int groups = kBlock / g;
  // every lane of a warp runs the same trips, so the shuffles see them all
  for (int base = 0; base < n_rows; base += groups) {
    const int i = base + group;
    float sum = 0.f;
    if (i < n_rows) {
      const int s = indptr[r0 + i] - static_cast<int>(a0);
      const int t = indptr[r0 + i + 1] - static_cast<int>(a0);
      for (int j = s + lane; j < t; j += g) {
        sum += prod[j];
      }
    }
    for (int offset = g / 2; offset > 0; offset >>= 1) {
      sum += __shfl_down_sync(kFull, sum, offset, g);
    }
    if (i < n_rows && lane == 0) {
      y[r0 + i] = sum;
    }
  }
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* vals,
           const void* x, void* y, const void* blocks, int n_blocks,
           void* stream) {
  if (n_blocks <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const bool quads =
      reinterpret_cast<std::uintptr_t>(indices) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(vals) % (4 * sizeof(T)) == 0;
  twell_stream_kernel<T><<<static_cast<unsigned>(n_blocks), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), static_cast<const int*>(blocks), quads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  `blocks` is the (n_blocks + 1,) int32
// row-block plan.  Each returns cudaGetLastError() after the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int twell_spmv_f32(const void* indptr, const void* indices,
                              const void* vals, const void* x, void* y,
                              const void* blocks, int n_blocks, void* stream) {
  return launch<float>(indptr, indices, vals, x, y, blocks, n_blocks, stream);
}

extern "C" int twell_spmv_bf16(const void* indptr, const void* indices,
                               const void* vals, const void* x, void* y,
                               const void* blocks, int n_blocks, void* stream) {
  return launch<__nv_bfloat16>(indptr, indices, vals, x, y, blocks, n_blocks,
                               stream);
}
