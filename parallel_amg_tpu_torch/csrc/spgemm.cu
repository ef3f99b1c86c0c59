// SpGEMM setup kernels on Hopper (sm_90a): the expand, merge and
// merge-and-compact steps of C = A·B for ELL operands (int32 columns, f32
// values), as the on-device Ruge–Stüben setup runs them for its Galerkin
// products R·A and (R·A)·P.
//
// Replaces three Pallas kernels of the JAX package:
// - spgemm_expand (B3): parallel_amg_tpu/ops/gspgemm.py::gather_candidates.
//   There a piece table re-buckets A's entries by 128-column window, B's
//   slot planes are replicated over 8 sublanes, and the in-window lane
//   shuffle does the gather.  A Hopper thread loads any address, so the
//   kernel reads A's ELL planes and B's rows directly: no plan, no windows.
// - spgemm_dedup (B5): parallel_amg_tpu/ops/pspgemm.py::_dedup_call.
// - spgemm_dedup_compact (B4): parallel_amg_tpu/ops/gspgemm.py::
//   _dedup_compact_call.  The TPU kernel ranks leaders with a lower-
//   triangular matmul (Mosaic has no lane cumsum); here a warp ballot and a
//   popcount give each leader its output slot.
//
// Candidates: row r of the product has K = Wa·Wb candidate slots.  Slot
// m·Wa + k holds A[r, k]·B[A.cols[r, k], m] and its column (m-major, the
// TPU kernel's order), or column SENT (= B's column count) and value 0 where
// k is past A's row length, m past B's row length, or the product is 0.
//
// Merge: within a row, the first slot of each column is its leader; the
// leader carries the sum of the values of every slot with that column, taken
// in ascending slot order, so results are bit-reproducible.  No atomics.
//
// What bounds each kernel on this card:
// - expand: device-memory bytes.  It reads A's planes once, B's rows (which
//   stay in the 50 MB L2 at the setup's shapes) and writes R·K·8 bytes of
//   candidates; one thread per candidate, consecutive threads write
//   consecutive words.
// - merge: the larger of R·K·8 bytes in (R·K·4 in count-only mode, which
//   reads no values) and R·K(K−1)/2 column compares.  One warp per row stages the row's candidates in shared memory (in
//   chunks of kStage when K is larger) and each lane tests its slots
//   against every staged slot: a broadcast read, no bank conflicts.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kStage = 512;  // candidates one warp stages in shared memory
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
    expand_kernel(const int* __restrict__ a_cols,
                  const float* __restrict__ a_vals,
                  const int* __restrict__ a_nnz,
                  const int* __restrict__ b_cols,
                  const float* __restrict__ b_vals,
                  const int* __restrict__ b_nnz, int* __restrict__ out_cols,
                  float* __restrict__ out_vals, long long n_rows, int wa,
                  int wb, int sent) {
  const long long K = static_cast<long long>(wa) * wb;
  const long long total = n_rows * K;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  for (long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
       t < total; t += stride) {
    const long long r = t / K;
    const int s = static_cast<int>(t - r * K);
    const int m = s / wa;
    const int k = s - m * wa;
    int col = sent;
    float val = 0.f;
    if (k < a_nnz[r]) {
      const long long ai = r * wa + k;
      const int c = a_cols[ai];
      if (m < b_nnz[c]) {
        const long long bi = static_cast<long long>(c) * wb + m;
        const float v = a_vals[ai] * b_vals[bi];
        if (v != 0.f) {
          col = b_cols[bi];
          val = v;
        }
      }
    }
    out_cols[t] = col;
    out_vals[t] = val;
  }
}

// One warp per row.  kCompact: write leaders to slots 0.. in slot order up
// to out_width and zeros after them (B4).  Otherwise leaders keep their slot
// and every other slot becomes (SENT, 0) (B5).  Without kVals (B5's
// count-only mode) the kernel reads only the columns, scans only the slots
// before each lane's own, and writes only the counts.  All write each row's
// uncapped count of distinct columns.
template <bool kCompact, bool kVals>
__global__ void __launch_bounds__(kBlock)
    merge_kernel(const int* __restrict__ cand_cols,
                 const float* __restrict__ cand_vals, int* __restrict__ out_cols,
                 float* __restrict__ out_vals, int* __restrict__ counts,
                 long long n_rows, int K, int out_width, int sent) {
  __shared__ int s_cols[kWarps][kStage];
  __shared__ float s_vals[kWarps][kVals ? kStage : 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= n_rows) {
    return;  // the whole warp leaves together
  }
  const int* rc = cand_cols + row * K;
  const float* rv = cand_vals + row * K;
  int* sc = s_cols[warp];
  float* sv = s_vals[warp];
  const bool resident = K <= kStage;
  if (resident) {
    for (int i = lane; i < K; i += 32) {
      sc[i] = rc[i];
      if (kVals) {
        sv[i] = rv[i];
      }
    }
    __syncwarp();
  }
  int count = 0;
  for (int j0 = 0; j0 < K; j0 += 32) {
    const int j = j0 + lane;
    const int cj = j < K ? (resident ? sc[j] : rc[j]) : sent;
    bool dup = false;
    float sum = 0.f;
    // a leader's sum needs every slot; the duplicate test only earlier ones
    const int k_end = kVals ? K : min(K, j0 + 32);
    for (int k0 = 0; k0 < k_end; k0 += kStage) {
      const int n = min(kStage, k_end - k0);
      if (!resident) {
        __syncwarp();
        for (int i = lane; i < n; i += 32) {
          sc[i] = rc[k0 + i];
          if (kVals) {
            sv[i] = rv[k0 + i];
          }
        }
        __syncwarp();
      }
      if (cj != sent && !dup) {
        const int i_end = kVals ? n : min(n, j - k0);
        for (int i = 0; i < i_end; ++i) {
          if (sc[i] == cj) {
            if (k0 + i < j) {
              dup = true;  // an earlier slot leads this column
              break;
            }
            if (kVals) {
              sum += sv[i];  // ascending slot order, from the leader on
            }
          }
        }
      }
    }
    const bool leader = cj != sent && !dup;
    const unsigned ballot = __ballot_sync(kFull, leader);
    if (kCompact) {
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (leader && slot < out_width) {
        out_cols[row * out_width + slot] = cj;
        out_vals[row * out_width + slot] = sum;
      }
    } else if (kVals && j < K) {
      out_cols[row * K + j] = leader ? cj : sent;
      out_vals[row * K + j] = leader ? sum : 0.f;
    }
    count += __popc(ballot);
  }
  if (kCompact) {
    for (int i = count + lane; i < out_width; i += 32) {
      out_cols[row * out_width + i] = 0;
      out_vals[row * out_width + i] = 0.f;
    }
  }
  if (lane == 0) {
    counts[row] = count;
  }
}

unsigned merge_blocks(long long n_rows) {
  return static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
}

}  // namespace

// Plain C entry points for ctypes.  Each returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.

// B3: (n_rows, wa·wb) candidate planes of A·B.  A: (n_rows, wa) planes and
// row lengths; B: (rows of B, wb) planes and row lengths; sent = B's column
// count.
extern "C" int spgemm_expand(const void* a_cols, const void* a_vals,
                             const void* a_nnz, const void* b_cols,
                             const void* b_vals, const void* b_nnz,
                             void* out_cols, void* out_vals, long long n_rows,
                             int wa, int wb, int sent, void* stream) {
  const long long total = n_rows * wa * wb;
  if (total <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long want = (total + kBlock - 1) / kBlock;
  const unsigned blocks =
      static_cast<unsigned>(want < (1LL << 30) ? want : (1LL << 30));
  expand_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a_cols), static_cast<const float*>(a_vals),
      static_cast<const int*>(a_nnz), static_cast<const int*>(b_cols),
      static_cast<const float*>(b_vals), static_cast<const int*>(b_nnz),
      static_cast<int*>(out_cols), static_cast<float*>(out_vals), n_rows, wa,
      wb, sent);
  return static_cast<int>(cudaGetLastError());
}

// B5: merge in place of slot; out_cols/out_vals may both be null (counts
// only).
extern "C" int spgemm_dedup(const void* cand_cols, const void* cand_vals,
                            void* out_cols, void* out_vals, void* counts,
                            long long n_rows, int k, int sent, void* stream) {
  if (n_rows <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto* cc = static_cast<const int*>(cand_cols);
  const auto* cv = static_cast<const float*>(cand_vals);
  if (out_cols == nullptr) {
    merge_kernel<false, false><<<merge_blocks(n_rows), kBlock, 0, cs>>>(
        cc, cv, nullptr, nullptr, static_cast<int*>(counts), n_rows, k, 0,
        sent);
  } else {
    merge_kernel<false, true><<<merge_blocks(n_rows), kBlock, 0, cs>>>(
        cc, cv, static_cast<int*>(out_cols), static_cast<float*>(out_vals),
        static_cast<int*>(counts), n_rows, k, 0, sent);
  }
  return static_cast<int>(cudaGetLastError());
}

// B4: merge and compact to (n_rows, out_width).
extern "C" int spgemm_dedup_compact(const void* cand_cols,
                                    const void* cand_vals, void* out_cols,
                                    void* out_vals, void* counts,
                                    long long n_rows, int k, int out_width,
                                    int sent, void* stream) {
  if (n_rows <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  merge_kernel<true, true><<<merge_blocks(n_rows), kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cand_cols), static_cast<const float*>(cand_vals),
      static_cast<int*>(out_cols), static_cast<float*>(out_vals),
      static_cast<int*>(counts), n_rows, k, out_width, sent);
  return static_cast<int>(cudaGetLastError());
}
