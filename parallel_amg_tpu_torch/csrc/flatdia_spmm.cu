// FlatDIA multi-RHS product on Hopper (sm_90a): Y[r, j] = sum_d W[d, r] *
// X[r + off_d, j] for D flattened diagonals and k right-hand sides.  W is
// stored (D, n) row-major in f32 or bf16; X and Y are f32, row-major with a
// leading dimension ld (the row stride, in elements); every sum is in f32.
//
// Replaces parallel_amg_tpu/ops/flatdia.py::_build_spmm (through dia_spmm).
// That Pallas kernel takes the right-hand sides TRANSPOSED, as (k, n) planes
// padded to a multiple of 8 sublanes, so the offset shifts ride the lane
// axis (the (n, k) sublane-shift layout crashed the Mosaic compiler), and
// double-buffers tile-plus-halo windows of them into VMEM.  On the card the
// vector grids of the vector path, (*node_dims, k) row-major, already are
// (n, k) with the k values of a row side by side: the kernel reads and
// writes them in place, with no transpose and no padding.
//
// Design:
// - One thread per row, grid-stride, with K accumulators in registers (K a
//   template argument, 1..8).  The thread walks the D offsets in order,
//   reads W[d*n + r] once for all K columns (neighbouring threads read
//   neighbouring words: every plane streams coalesced), reads the K values
//   of row r + off_d (0 outside [0, n)), and stores its K sums once.
// - More than 8 right-hand sides go in chunks of at most 8 columns: the
//   wrapper moves X and Y to the chunk's first column and passes ld.
// - The offsets ride in a by-value parameter (at most kMaxDiags); a wider
//   operator is split into launches that add into Y (accumulate = 1).
// - No atomics and a fixed summation order: Y is bit-reproducible.
// - Row and plane offsets (d*n, r*ld) are computed in 64 bits.
//
// What bounds it: device-memory bytes.  W is D*n*(4 or 2) bytes, read once;
// X is n*k*4 bytes, read D times but from the 50 MB L2 for the near
// offsets, so about one pass; Y is n*k*4 bytes.  At 128^3 with 7 points and
// k = 3 that is about 109 MB per product.
//
// What it is for: Stencil.matmat on the card, which carries every
// BlockStencil level and every transfer of the vector path (the scalar
// stencil applied to each of the bs components).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kMaxDiags = 192;
constexpr int kMaxCols = 8;

// Plain-C layout shared with the ctypes wrapper (ops/flatdia.py); the same
// struct as csrc/flatdia_spmv.cu's.
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

template <typename T, int K>
__global__ void __launch_bounds__(kBlock)
    flatdia_spmm_kernel(const T* __restrict__ W, const float* __restrict__ X,
                        float* __restrict__ Y, long long n, long long ld,
                        DiaOffsets offs, int accumulate) {
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long r = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       r < n; r += stride) {
    float acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      acc[j] = accumulate ? Y[r * ld + j] : 0.f;
    }
    for (int d = 0; d < offs.count; ++d) {
      const long long c = r + offs.off[d];
      const float w = to_float(W[d * n + r]);
      if (c >= 0 && c < n) {
        const float* xr = X + c * ld;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          acc[j] += w * __ldg(xr + j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      Y[r * ld + j] = acc[j];
    }
  }
}

template <typename T, int K>
void launch_k(const T* W, const float* X, float* Y, long long n, long long ld,
              DiaOffsets offs, int accumulate, unsigned blocks,
              cudaStream_t stream) {
  flatdia_spmm_kernel<T, K><<<blocks, kBlock, 0, stream>>>(
      W, X, Y, n, ld, offs, accumulate);
}

template <typename T>
int launch(const void* W, const void* X, void* Y, long long n, long long ld,
           int k, DiaOffsets offs, int accumulate, void* stream) {
  if (offs.count < 0 || offs.count > kMaxDiags || n < 0 || k < 1 ||
      k > kMaxCols || ld < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  const T* w = static_cast<const T*>(W);
  const float* x = static_cast<const float*>(X);
  float* y = static_cast<float*>(Y);
  const unsigned b = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch_k<T, 1>(w, x, y, n, ld, offs, accumulate, b, s); break;
    case 2: launch_k<T, 2>(w, x, y, n, ld, offs, accumulate, b, s); break;
    case 3: launch_k<T, 3>(w, x, y, n, ld, offs, accumulate, b, s); break;
    case 4: launch_k<T, 4>(w, x, y, n, ld, offs, accumulate, b, s); break;
    case 5: launch_k<T, 5>(w, x, y, n, ld, offs, accumulate, b, s); break;
    case 6: launch_k<T, 6>(w, x, y, n, ld, offs, accumulate, b, s); break;
    case 7: launch_k<T, 7>(w, x, y, n, ld, offs, accumulate, b, s); break;
    default: launch_k<T, 8>(w, x, y, n, ld, offs, accumulate, b, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  W points at the first of offs.count
// planes of n values each; X and Y at column 0 of a chunk of k (1..8)
// columns of row-major (n, ld) matrices.  accumulate = 0 stores the sums
// into Y, 1 adds them to Y.  Each returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int flatdia_spmm_f32(const void* W, const void* X, void* Y,
                                long long n, long long ld, int k,
                                DiaOffsets offs, int accumulate,
                                void* stream) {
  return launch<float>(W, X, Y, n, ld, k, offs, accumulate, stream);
}

extern "C" int flatdia_spmm_bf16(const void* W, const void* X, void* Y,
                                 long long n, long long ld, int k,
                                 DiaOffsets offs, int accumulate,
                                 void* stream) {
  return launch<__nv_bfloat16>(W, X, Y, n, ld, k, offs, accumulate, stream);
}
