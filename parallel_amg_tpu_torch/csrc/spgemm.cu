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
//   _dedup_compact_call.  The TPU kernel compares every pair of slots and
//   ranks leaders with a lower-triangular matmul (Mosaic has no lane
//   cumsum).  Here a warp owns a row and a hash table of its columns:
//   __match_any_sync groups the lanes of a 32-slot chunk that hold one
//   column, the group's lowest lane finds or inserts the column and adds the
//   group's values in lane order, and a ballot and a popcount give each
//   leader its output slot.
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
// - merge (B5): the larger of R·K·8 bytes in (R·K·4 in count-only mode,
//   which reads no values) and R·K(K−1)/2 column compares.  One warp per row
//   stages the row's candidates in shared memory (in chunks of kStage when K
//   is larger) and each lane tests its slots against every staged slot: a
//   broadcast read, no bank conflicts.
// - merge and compact (B4): R·K·8 bytes in and R·out_width·8 out; its
//   instructions are O(K/32 + duplicates) per row, not B5's O(K·K/32): one
//   pass inserts each chunk's columns in the warp's table (a power of two
//   ≥ 2K slots, open addressing), a second ranks the leaders.  The table
//   lives in shared memory while it fits (K ≤ kMaxSharedK), else in global
//   scratch that the caller passes.

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

// B5, one warp per row: leaders keep their slot and every other slot becomes
// (SENT, 0).  Without kVals (count-only mode) the kernel reads only the
// columns, scans only the slots before each lane's own, and writes only the
// counts.  Both write each row's count of distinct columns.
template <bool kVals>
__global__ void __launch_bounds__(kBlock)
    merge_kernel(const int* __restrict__ cand_cols,
                 const float* __restrict__ cand_vals, int* __restrict__ out_cols,
                 float* __restrict__ out_vals, int* __restrict__ counts,
                 long long n_rows, int K, int sent) {
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
    if (kVals && j < K) {
      out_cols[row * K + j] = leader ? cj : sent;
      out_vals[row * K + j] = leader ? sum : 0.f;
    }
    count += __popc(ballot);
  }
  if (lane == 0) {
    counts[row] = count;
  }
}

// B4's per-warp table: keys (SENT marks an empty slot: SENT slots are never
// inserted) and each key's running sum, the row's K candidates staged, and
// one bit per slot that marks the leaders.
struct WarpTable {
  int* keys;
  float* sums;
  int* cols;
  float* vals;
  unsigned* leaders;
};

constexpr int kMinTable = 64;
constexpr int kPrefetch = 4;  // B4's candidate chunks loaded together
constexpr int kMaxSharedK = 4096;  // 2K ≤ 8192 slots: 97 KB a warp
// a block's shared tables: blocks of a few warps keep more warps on an SM
// than one large block when the tables are large
constexpr long long kSharedBudget = 48 * 1024;
constexpr int kMaxK = 1 << 28;  // the table's 2^29 slots still index in int

__host__ __device__ inline int table_size(int K) {
  int t = kMinTable;
  while (t < 2LL * K) {
    t *= 2;
  }
  return t;
}

__host__ __device__ inline long long warp_table_bytes(int K) {
  const long long t = table_size(K);
  return 8 * t + 8LL * K + 4 * ((K + 31) / 32);
}

__device__ inline WarpTable carve_table(char* base, int K) {
  const int t = table_size(K);
  WarpTable w;
  w.keys = reinterpret_cast<int*>(base);
  w.sums = reinterpret_cast<float*>(w.keys + t);
  w.cols = reinterpret_cast<int*>(w.sums + t);
  w.vals = reinterpret_cast<float*>(w.cols + K);
  w.leaders = reinterpret_cast<unsigned*>(w.vals + K);
  return w;
}

// Fibonacci hashing: the top log2(T) bits of col·2^32/φ, which depend on
// every bit of col (columns equal modulo T spread out).
__device__ inline int hash_slot(int col, int shift) {
  return static_cast<int>((static_cast<unsigned>(col) * 0x9E3779B1u) >> shift);
}

// One warp per row (grid-stride over rows).  The row's live (non-SENT)
// candidates are staged first, compacted in slot order, so the passes walk
// only chunks of live slots.  Pass 1 walks those 32-slot chunks in order:
// the lanes of each column group (__match_any_sync) elect their lowest lane,
// which finds or inserts the column (atomicCAS on the key; the inserting
// lane's slot is the leader, marked in a bit) and adds the group's values
// to the running sum in lane order.  Chunks run in order and a
// column's entry is touched by one lane per chunk, so every sum is taken in
// ascending slot order from 0, as B5 takes it: the output equals B5's
// in-place merge compacted in slot order, bit for bit.  Pass 2 ranks the
// leaders in slot order (ballot + popcount) and writes them, zeros after.
// kShared: the tables are dynamic shared memory (the compiler then emits
// shared loads, stores and atomics); else `scratch` (global) holds one table
// per warp of the grid, for K too large for shared memory.
template <bool kShared>
__global__ void __launch_bounds__(kBlock)
    dedup_compact_kernel(const int* __restrict__ cand_cols,
                         const float* __restrict__ cand_vals,
                         int* __restrict__ out_cols,
                         float* __restrict__ out_vals, int* __restrict__ counts,
                         long long n_rows, int K, int out_width, int sent,
                         char* scratch) {
  extern __shared__ __align__(16) char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tbytes = warp_table_bytes(K);
  char* base = kShared ? smem + warp * tbytes
                       : scratch + (static_cast<long long>(blockIdx.x) * warps + warp) * tbytes;
  const WarpTable tab = carve_table(base, K);
  const int tmask = table_size(K) - 1;
  const int shift = 32 - (__ffs(tmask + 1) - 1);
  const int n_chunks = (K + 31) / 32;
  const unsigned below = (1u << lane) - 1u;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp;
       row < n_rows; row += static_cast<long long>(gridDim.x) * warps) {
    const int* rc = cand_cols + row * K;
    const float* rv = cand_vals + row * K;
    for (int i = lane; i <= tmask; i += 32) {
      tab.keys[i] = sent;
    }
    // stage the live candidates, compacted in slot order; kPrefetch chunks'
    // loads are in flight together
    int live = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += kPrefetch) {
      int cols[kPrefetch];
      float vals[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int j = (c0 + u) * 32 + lane;
        cols[u] = j < K ? __ldg(rc + j) : sent;
        vals[u] = j < K ? __ldg(rv + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const unsigned bits = __ballot_sync(kFull, cols[u] != sent);
        if (cols[u] != sent) {
          const int at = live + __popc(bits & below);
          tab.cols[at] = cols[u];
          tab.vals[at] = vals[u];
        }
        live += __popc(bits);
      }
    }
    __syncwarp();
    const int n_live = (live + 31) / 32;
    int count = 0;
    for (int c = 0; c < n_live; ++c) {
      const int j = c * 32 + lane;
      const int cj = j < live ? tab.cols[j] : sent;
      const unsigned peers = __match_any_sync(kFull, cj);
      bool inserted = false;
      if (cj != sent && lane == __ffs(peers) - 1) {
        int slot = hash_slot(cj, shift);
        while (true) {
          const int key = tab.keys[slot];
          if (key == cj) {
            break;
          }
          if (key == sent) {
            const int old = atomicCAS(tab.keys + slot, sent, cj);
            if (old == sent) {
              tab.sums[slot] = 0.f;
              inserted = true;
              break;
            }
            if (old == cj) {
              break;
            }
          }
          slot = (slot + 1) & tmask;
        }
        float sum = tab.sums[slot];
        for (unsigned m = peers; m != 0u; m &= m - 1u) {
          sum = __fadd_rn(sum, tab.vals[c * 32 + __ffs(m) - 1]);  // lane order
        }
        tab.sums[slot] = sum;
      }
      const unsigned lead_bits = __ballot_sync(kFull, inserted);
      if (lane == 0) {
        tab.leaders[c] = lead_bits;
      }
      count += __popc(lead_bits);
      __syncwarp();
    }
    int rank = 0;
    for (int c = 0; c < n_live && rank < out_width; ++c) {
      const unsigned lead_bits = tab.leaders[c];
      const int j = c * 32 + lane;
      const int at = rank + __popc(lead_bits & below);
      if (((lead_bits >> lane) & 1u) != 0u && at < out_width) {
        const int cj = tab.cols[j];
        int slot = hash_slot(cj, shift);
        while (tab.keys[slot] != cj) {
          slot = (slot + 1) & tmask;
        }
        out_cols[row * out_width + at] = cj;
        out_vals[row * out_width + at] = tab.sums[slot];
      }
      rank += __popc(lead_bits);
    }
    for (int i = min(count, out_width) + lane; i < out_width; i += 32) {
      out_cols[row * out_width + i] = 0;
      out_vals[row * out_width + i] = 0.f;
    }
    if (lane == 0) {
      counts[row] = count;
    }
    __syncwarp();
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
    merge_kernel<false><<<merge_blocks(n_rows), kBlock, 0, cs>>>(
        cc, cv, nullptr, nullptr, static_cast<int*>(counts), n_rows, k, sent);
  } else {
    merge_kernel<true><<<merge_blocks(n_rows), kBlock, 0, cs>>>(
        cc, cv, static_cast<int*>(out_cols), static_cast<float*>(out_vals),
        static_cast<int*>(counts), n_rows, k, sent);
  }
  return static_cast<int>(cudaGetLastError());
}

// B4's global scratch in bytes for each warp of the grid: 0 where its table
// fits in shared memory (K ≤ kMaxSharedK).
extern "C" long long spgemm_dedup_compact_scratch(int k) {
  return k > kMaxSharedK ? warp_table_bytes(k) : 0;
}

// B4: merge and compact to (n_rows, out_width).  With K above kMaxSharedK
// the caller passes scratch_warps tables of spgemm_dedup_compact_scratch(k)
// bytes each in `scratch`.
extern "C" int spgemm_dedup_compact(const void* cand_cols,
                                    const void* cand_vals, void* out_cols,
                                    void* out_vals, void* counts,
                                    long long n_rows, int k, int out_width,
                                    int sent, void* scratch,
                                    long long scratch_warps, void* stream) {
  if (n_rows <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (k < 0 || k > kMaxK || out_width <= 0 ||
      (k > kMaxSharedK && (scratch == nullptr || scratch_warps < kWarps))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const long long tbytes = warp_table_bytes(k);
  const bool shared = k <= kMaxSharedK;
  // shared tables: as many warps a block as fit in kSharedBudget (1 to 8)
  const long long fit = kSharedBudget / tbytes;
  const int warps = !shared || fit >= kWarps ? kWarps
                    : fit < 1                ? 1
                                             : static_cast<int>(fit);
  const long long want = (n_rows + warps - 1) / warps;
  const long long cap = shared ? (1LL << 30) : scratch_warps / kWarps;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  const size_t smem = shared ? static_cast<size_t>(tbytes) * warps : 0;
  const auto* cc = static_cast<const int*>(cand_cols);
  const auto* cv = static_cast<const float*>(cand_vals);
  auto* oc = static_cast<int*>(out_cols);
  auto* ov = static_cast<float*>(out_vals);
  auto* cnt = static_cast<int*>(counts);
  if (!shared) {
    dedup_compact_kernel<false><<<blocks, warps * 32, 0, cs>>>(
        cc, cv, oc, ov, cnt, n_rows, k, out_width, sent,
        static_cast<char*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dedup_compact_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  dedup_compact_kernel<true><<<blocks, warps * 32, smem, cs>>>(
      cc, cv, oc, ov, cnt, n_rows, k, out_width, sent, nullptr);
  return static_cast<int>(cudaGetLastError());
}
