// FlatDIA SpMV on Hopper (sm_90a): y[r] = sum_d W[d, r] * x[r + off_d] over
// D flattened diagonals, W stored (D, n) row-major in f32 or bf16; x and y
// are f32 and every sum is taken in f32.
//
// Replaces parallel_amg_tpu/ops/flatdia.py::_build_spmv (through dia_spmv).
// That Pallas kernel pads x by the halo, pads W to a multiple of a 1024-lane
// tile, and double-buffers tile-plus-halo windows of x into VMEM with
// make_async_copy, because Mosaic reads VMEM slices only.  A Hopper thread
// loads any address and the 50 MB L2 holds x, so none of that carries over.
//
// Design:
// - One thread per row, grid-stride.  The thread walks the D offsets in
//   order, reads W[d*n + r] (neighbouring threads read neighbouring words:
//   every plane streams coalesced), reads x[r + off_d] with the column
//   bounds-checked to [0, n) (0 outside), and stores y[r] once.
// - The offsets ride in a by-value kernel parameter (at most kMaxDiags), not
//   in a __constant__ global that every stream would share.  The wrapper
//   splits a wider matrix into launches of kMaxDiags planes that add into y.
// - No atomics and a fixed summation order: y is bit-reproducible.
// - d*n is indexed in 64 bits.
//
// What bounds it: device-memory bytes.  W is D*n*(4 or 2) bytes, read once;
// x (n*4 bytes, 8 MB at 128^3) is read D times but stays in the 50 MB L2, so
// it costs about one pass; y is n*4 bytes.  At 128^3 with 7 points that is
// about 75 MB per matvec.  The coarse levels (79,507 rows and fewer) and the
// Ruge-Stueben DIA levels do too little work to fill the card, and launch
// latency bounds them instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxDiags = 192;

// Plain-C layout shared with the ctypes wrapper (ops/flatdia.py).
struct DiaOffsets {
  int count;
  int off[kMaxDiags];
};

namespace {

constexpr int kBlock = 256;
constexpr long long kMaxBlocks = 65535;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
    flatdia_spmv_kernel(const T* __restrict__ W, const float* __restrict__ x,
                        float* __restrict__ y, long long n, DiaOffsets offs,
                        int accumulate) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long r = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       r < n; r += stride) {
    float acc = accumulate ? y[r] : 0.f;
    for (int d = 0; d < offs.count; ++d) {
      const long long c = r + offs.off[d];
      const float xv = (c >= 0 && c < n) ? __ldg(x + c) : 0.f;
      acc += to_float(W[d * n + r]) * xv;
    }
    y[r] = acc;
  }
}

template <typename T>
int launch(const void* W, const void* x, void* y, long long n,
           DiaOffsets offs, int accumulate, void* stream) {
  if (offs.count < 0 || offs.count > kMaxDiags || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  flatdia_spmv_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(W), static_cast<const float*>(x),
      static_cast<float*>(y), n, offs, accumulate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  W points at the first of offs.count
// planes of n values each.  accumulate = 0 stores the sum into y, 1 adds it
// to y.  Each returns cudaGetLastError() after the launch (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int flatdia_spmv_f32(const void* W, const void* x, void* y,
                                long long n, DiaOffsets offs, int accumulate,
                                void* stream) {
  return launch<float>(W, x, y, n, offs, accumulate, stream);
}

extern "C" int flatdia_spmv_bf16(const void* W, const void* x, void* y,
                                 long long n, DiaOffsets offs, int accumulate,
                                 void* stream) {
  return launch<__nv_bfloat16>(W, x, y, n, offs, accumulate, stream);
}
