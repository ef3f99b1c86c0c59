// Block-ELL (BSR) SpMV on Hopper (sm_90a): y = A x for a matrix of bs x bs
// dense blocks, bs = 1..8.  Block row r holds brow_nnz[r] blocks in slots
// w = 0, 1, ...; slot w's block column is bcols[w*RB + r] (int32, stored
// slot-major), and entry (i, j) of its block is the value plane
// p = (w*bs + i)*bs + j at vals[p*RB + r] (f32 or bf16).  x and y are f32
// and strided: component j of block column c is x[c*xn + j*xc], component i
// of block row r is y[r*yn + i*yc].  Every sum is in f32.
//
// Replaces parallel_amg_tpu/ops/btwell.py::BTWELL.matvec_planes.  That
// Pallas kernel re-packs the blocks into 128-lane tile windows with int8
// in-window indices, sublane-replicates x 8 times and walks scalar-prefetched
// piece tables, because Mosaic gathers only inside a 128-lane tile.  A
// Hopper thread loads any address, so the kernel reads the block-ELL layout
// that BSR and the port's BTWELL share, and x where it lies: flat node-major
// (xn = bs, xc = 1) for BSR.matvec, component planes (xn = 1, xc = n) for
// BTWELL.matvec_planes, with no transpose copy.
//
// Design:
// - One thread per block row, grid-stride, with bs accumulators in
//   registers (bs a template argument).  Per slot the thread reads its
//   block column (coalesced: neighbouring threads, neighbouring words), the
//   bs components of x at that column (a gather; the near block columns of
//   a stencil row are the neighbouring threads' too, so they come from L2),
//   and the bs*bs value planes (each read coalesced), then does bs*bs FMAs.
// - Slots past brow_nnz[r] are not read, so a matrix with zero blocks
//   dropped (the port's BTWELL) moves fewer bytes than its padded BSR.
// - Block columns outside [0, MB) are skipped (the builders never write
//   one; the check keeps a bad matrix from reading outside x).
// - Every plane and slot offset (p*RB, w*RB) is 64-bit: at 324^3 x 3 the
//   value planes hold 7*9*34,012,224 = 2,142,770,112 elements, 0.2 % below
//   2^31, and a wider stencil passes it.
// - No atomics and a fixed summation order: y is bit-reproducible.
//
// What bounds it: device-memory bytes.  The value planes (WB*bs*bs*RB*4
// bytes in f32) dominate; the block columns add WB*RB*4, brow_nnz RB*4, x
// and y RB*bs*4 each.  At 128^3 x 3 that is about 645 MB per product, at
// 324^3 x 3 about 10.3 GB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr long long kMaxBlocks = 65535;
constexpr int kMaxBs = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int BS>
__global__ void __launch_bounds__(kBlock)
    bsr_spmv_kernel(const int* __restrict__ bcols, const T* __restrict__ vals,
                    const int* __restrict__ brow_nnz,
                    const float* __restrict__ x, float* __restrict__ y,
                    long long RB, int WB, long long MB, long long xn,
                    long long xc, long long yn, long long yc) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long r = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       r < RB; r += stride) {
    float acc[BS];
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      acc[i] = 0.f;
    }
    const int cnt = min(brow_nnz[r], WB);
    for (int w = 0; w < cnt; ++w) {
      const long long c = bcols[static_cast<long long>(w) * RB + r];
      if (c < 0 || c >= MB) {
        continue;
      }
      float xv[BS];
#pragma unroll
      for (int j = 0; j < BS; ++j) {
        xv[j] = __ldg(x + c * xn + j * xc);
      }
      const T* v = vals + static_cast<long long>(w) * (BS * BS) * RB + r;
#pragma unroll
      for (int i = 0; i < BS; ++i) {
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          acc[i] += to_float(v[static_cast<long long>(i * BS + j) * RB]) * xv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      y[r * yn + i * yc] = acc[i];
    }
  }
}

template <typename T, int BS>
void launch_bs(const void* bcols, const void* vals, const void* brow_nnz,
               const void* x, void* y, long long RB, int WB, long long MB,
               long long xn, long long xc, long long yn, long long yc,
               unsigned blocks, cudaStream_t stream) {
  bsr_spmv_kernel<T, BS><<<blocks, kBlock, 0, stream>>>(
      static_cast<const int*>(bcols), static_cast<const T*>(vals),
      static_cast<const int*>(brow_nnz), static_cast<const float*>(x),
      static_cast<float*>(y), RB, WB, MB, xn, xc, yn, yc);
}

template <typename T>
int launch(const void* bcols, const void* vals, const void* brow_nnz,
           const void* x, void* y, long long RB, int WB, int bs, long long MB,
           long long xn, long long xc, long long yn, long long yc,
           void* stream) {
  if (RB < 0 || WB < 0 || MB < 0 || bs < 1 || bs > kMaxBs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (RB == 0) {
    return static_cast<int>(cudaSuccess);
  }
  long long blocks = (RB + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  const unsigned b = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BSR_CASE(BS)                                                       \
  case BS:                                                                 \
    launch_bs<T, BS>(bcols, vals, brow_nnz, x, y, RB, WB, MB, xn, xc, yn, \
                     yc, b, s);                                            \
    break;
  switch (bs) {
    BSR_CASE(1)
    BSR_CASE(2)
    BSR_CASE(3)
    BSR_CASE(4)
    BSR_CASE(5)
    BSR_CASE(6)
    BSR_CASE(7)
    BSR_CASE(8)
  }
#undef BSR_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  RB block rows, WB slots, bs x bs blocks,
// MB block columns; xn/xc and yn/yc are the node and component strides of x
// and y in elements.  Each returns cudaGetLastError() after the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int bsr_spmv_f32(const void* bcols, const void* vals,
                            const void* brow_nnz, const void* x, void* y,
                            long long RB, int WB, int bs, long long MB,
                            long long xn, long long xc, long long yn,
                            long long yc, void* stream) {
  return launch<float>(bcols, vals, brow_nnz, x, y, RB, WB, bs, MB, xn, xc, yn,
                       yc, stream);
}

extern "C" int bsr_spmv_bf16(const void* bcols, const void* vals,
                             const void* brow_nnz, const void* x, void* y,
                             long long RB, int WB, int bs, long long MB,
                             long long xn, long long xc, long long yn,
                             long long yc, void* stream) {
  return launch<__nv_bfloat16>(bcols, vals, brow_nnz, x, y, RB, WB, bs, MB, xn,
                               xc, yn, yc, stream);
}
