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
//   Here a thread owns one A entry and makes all its products with B's
//   row, read as one run; a block stages a tile of whole rows in shared
//   memory in slot order and writes it out as one contiguous run per
//   plane.
// - spgemm_dedup (B5): parallel_amg_tpu/ops/pspgemm.py::_dedup_call.
// - spgemm_dedup_compact (B4): parallel_amg_tpu/ops/gspgemm.py::
//   _dedup_compact_call.  The TPU kernels compare every pair of slots and
//   rank leaders with a lower-triangular matmul (Mosaic has no lane
//   cumsum).  Here B4 and both modes of B5 are one per-row routine,
//   merge_kernel, with three output modes (count, in place, compact): a
//   warp owns a row and an open-addressing hash table of its columns, and
//   a lane finds or inserts a column with an atomicCAS on the key.
//
// Candidates: row r of the product has K = Wa·Wb candidate slots.  Slot
// m·Wa + k holds A[r, k]·B[A.cols[r, k], m] and its column (m-major, the
// TPU kernel's order), or column SENT (= B's column count) and value 0 where
// k is past A's row length, m past B's row length, or the product is 0.
//
// Merge: within a row, the first slot of each column is its leader; the
// leader carries the sum of the values of every slot with that column, taken
// in ascending slot order, so results are bit-reproducible.  Every mode
// writes each row's count of distinct columns.
//
// What bounds each kernel on this card:
// - expand: device-memory bytes.  It reads A's planes once, B's rows (which
//   stay in the 50 MB L2 at the setup's shapes) and writes R·K·8 bytes of
//   candidates, 73 % of the bytes at config #2's level-0 (R·A)·P.  So
//   everything in front of the writes is cut down: A's entry is loaded
//   once for its Wb products (not once per candidate), B's row in 16-byte
//   loads where Wb allows, no divide per candidate (one per work item),
//   and no branch at the store: padding and zero products are staged as
//   (SENT, 0).  The tile leaves shared memory as one contiguous run per
//   plane in 16-byte streaming stores, and the block gathers its next tile
//   into the other buffer (expand_plan and expand_kernel say how a tile is
//   cut).
// - merge, every mode: R·K·4 bytes of columns in (R·K·8 with the values
//   outside count mode) and one table insert or lookup per live candidate:
//   O(K/32 + duplicates) warp instructions per row, not the O(K·K/32)
//   compares of an all-pairs merge.  The table is a power of two ≥ 2K
//   slots (open addressing), in shared memory while it fits
//   (kMaxSharedTable bytes a warp), else in global scratch that the caller
//   passes.
//   - count (B5 as the setup runs it): keys only, 4 bytes a slot, nothing
//     staged and no value read.  Every live lane inserts its own column;
//     of the lanes that hold one column exactly one atomicCAS wins, and the
//     winners, summed by ballot and popcount, are the count, whatever the
//     order of the inserts.  (Grouping equal columns first with
//     __match_any_sync, as the other modes must, was slower on config #2's
//     products.)
//   - in place (B5) and compact (B4): the row's live candidates are staged
//     in slot order, then pass 1 walks them in 32-slot chunks in order;
//     __match_any_sync groups the lanes of a chunk that hold one column and
//     the group's lowest lane finds or inserts the column and adds the
//     group's values, in lane order, to its running sum, so every sum runs
//     in ascending slot order.
//     Pass 2 writes each leader's sum at its own slot and (SENT, 0)
//     elsewhere (in place) or ranks the leaders by ballot and popcount and
//     writes them to the front (compact).  Both read one pass 1, so B4
//     equals B5's in-place merge compacted, bit for bit, by construction.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

// B3 stages a tile's slots of each plane in shared memory: 2,048 slots
// (16 KB of columns and values) a buffer, two buffers a block (32 KB).
// kStageWords leaves room for the 0-3 words that shift a tile to its
// global alignment.
constexpr int kStageSlots = 2048;
constexpr int kStageWords = kStageSlots + 4;
constexpr size_t kStageBytes = 4 * kStageWords * sizeof(int);

// Device ordinals whose resident block count launch_expand remembers.
constexpr int kMaxDevices = 64;

// B3's tiling, fixed by Wa and Wb.  A tile is a contiguous run of slots of
// the (R, K) planes: `rows` whole rows (a multiple of 4 where at least 4
// rows fit, so those tiles start 16-byte-aligned), or, where one row has
// more than kStageSlots slots, a range of `m_span` values of m of one row
// (all of A's entries), or, where Wa alone passes kStageSlots, `k_span`
// entries of one m.  A work item is one A entry (r, k) and up to `m_group`
// values of m: m_group is the tile's m range, cut into groups only where
// the tile has fewer entries than the block has threads.  `vec` is the
// width of B's row loads (4, 2 or 1 words; it divides Wb and m_span).
struct ExpandPlan {
  int rows;
  int m_span;
  int k_span;
  int m_group;
  int vec;
};

ExpandPlan expand_plan(int wa, int wb) {
  ExpandPlan p{1, wb, wa, wb, wb % 4 == 0 ? 4 : wb % 2 == 0 ? 2 : 1};
  const long long K = static_cast<long long>(wa) * wb;
  if (K <= kStageSlots) {
    p.rows = static_cast<int>(kStageSlots / K);
    if (p.rows >= 4) {
      p.rows -= p.rows % 4;
    }
  } else if (wa <= kStageSlots) {
    p.m_span = kStageSlots / wa;
    while (p.m_span < p.vec) {
      p.vec /= 2;
    }
    p.m_span -= p.m_span % p.vec;
  } else {
    p.m_span = 1;
    p.k_span = kStageSlots;
    p.vec = 1;
  }
  const int entries = p.rows * p.k_span;
  const int steps = p.m_span / p.vec;
  int groups = entries >= kBlock ? 1 : kBlock / entries;
  groups = groups < steps ? groups : steps;
  p.m_group = (steps + groups - 1) / groups * p.vec;
  return p;
}

// Copy the n words staged at s to g, where s and g agree modulo 16 bytes:
// the 16-byte-aligned middle by 16-byte streaming stores (st.global.cs)
// from every thread, the 0-3 words on either side by plain stores.
__device__ inline void store_run(int* g, const int* s, int n) {
  const int lead = static_cast<int>((reinterpret_cast<unsigned long long>(g) >> 2) & 3);
  const int head = min(n, (4 - lead) & 3);
  const int body = (n - head) & ~3;
  const int t = threadIdx.x;
  const auto* src = reinterpret_cast<const int4*>(s + head);
  auto* dst = reinterpret_cast<int4*>(g + head);
  for (int i = t; i < body / 4; i += kBlock) {
    __stcs(dst + i, src[i]);
  }
  if (t < head) {
    g[t] = s[t];
  } else if (t < n - body) {  // the tail: words head + body + (t - head)
    g[body + t] = s[body + t];
  }
}

// B's row run of V words at b (16-, 8- or 4-byte-aligned), read-only.
template <int V>
__device__ inline void load_b(const int* bc, const float* bv, int* c, float* v) {
  if constexpr (V == 4) {
    const int4 c4 = __ldg(reinterpret_cast<const int4*>(bc));
    const float4 v4 = __ldg(reinterpret_cast<const float4*>(bv));
    c[0] = c4.x, c[1] = c4.y, c[2] = c4.z, c[3] = c4.w;
    v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
  } else if constexpr (V == 2) {
    const int2 c2 = __ldg(reinterpret_cast<const int2*>(bc));
    const float2 v2 = __ldg(reinterpret_cast<const float2*>(bv));
    c[0] = c2.x, c[1] = c2.y;
    v[0] = v2.x, v[1] = v2.y;
  } else {
    c[0] = __ldg(bc);
    v[0] = __ldg(bv);
  }
}

// Persistent blocks walk the tiles of plan p.  Per tile: every thread
// gathers its work items into the tile's staging buffer in slot order,
// then the tile leaves as one contiguous run per plane (store_run); two
// buffers let one tile's store drain while the next is gathered.
template <int V>
__global__ void __launch_bounds__(kBlock)
    expand_kernel(const int* __restrict__ a_cols,
                  const float* __restrict__ a_vals,
                  const int* __restrict__ a_nnz,
                  const int* __restrict__ b_cols,
                  const float* __restrict__ b_vals,
                  const int* __restrict__ b_nnz, int* __restrict__ out_cols,
                  float* __restrict__ out_vals, long long n_rows, int wa,
                  int wb, int sent, ExpandPlan p, long long n_tiles) {
  extern __shared__ __align__(16) int stage[];  // [buffer][cols, vals][word]
  const long long K = static_cast<long long>(wa) * wb;
  const int k_chunks = (wa + p.k_span - 1) / p.k_span;
  const int chunks = (wb + p.m_span - 1) / p.m_span * k_chunks;
  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    // the tile: rows [r0, r0 + nr), m [m0, m0 + mt), k [k0, k0 + kt)
    const long long rt = tile / chunks;
    const int c = static_cast<int>(tile - rt * chunks);
    const long long r0 = rt * p.rows;
    const int nr = static_cast<int>(n_rows - r0 < p.rows ? n_rows - r0 : p.rows);
    const int m0 = c / k_chunks * p.m_span;
    const int k0 = c % k_chunks * p.k_span;
    const int mt = min(p.m_span, wb - m0);
    const int kt = min(p.k_span, wa - k0);
    const int n = nr * mt * kt;
    const long long first = r0 * K + static_cast<long long>(m0) * wa + k0;
    int* gc = out_cols + first;
    float* gv = out_vals + first;
    // staged word i sits at the global word's offset modulo 16 bytes
    int* sc = stage + buf * 2 * kStageWords +
              static_cast<int>((reinterpret_cast<unsigned long long>(gc) >> 2) & 3);
    float* sv = reinterpret_cast<float*>(stage + (buf * 2 + 1) * kStageWords) +
                static_cast<int>((reinterpret_cast<unsigned long long>(gv) >> 2) & 3);
    const int groups = (mt + p.m_group - 1) / p.m_group;
    const int items = nr * kt * groups;
    for (int w = threadIdx.x; w < items; w += kBlock) {
      const int q = w / kt;
      const int kl = w - q * kt;
      const int rl = q / groups;
      const int ms = (q - rl * groups) * p.m_group;
      const int me = min(ms + p.m_group, mt);
      const long long r = r0 + rl;
      const int k = k0 + kl;
      // slot (rl, m, kl) of the tile at word m·kt; consecutive threads hold
      // consecutive k, so they write consecutive words
      int* dc = sc + rl * mt * kt + kl;
      float* dv = sv + rl * mt * kt + kl;
      // the entry and its row length in one round trip (a padding slot of
      // A's planes is in bounds, and its column is not used)
      const long long ai = r * wa + k;
      const int col = __ldg(a_cols + ai);
      const float av = __ldg(a_vals + ai);
      if (k >= __ldg(a_nnz + r)) {
        for (int m = ms; m < me; ++m) {
          dc[m * kt] = sent;
          dv[m * kt] = 0.f;
        }
        continue;
      }
      const int nb = __ldg(b_nnz + col) - m0;
      const long long bi = static_cast<long long>(col) * wb + m0;
      for (int m = ms; m < me; m += V) {
        int bc[V];
        float bv[V];
        load_b<V>(b_cols + bi + m, b_vals + bi + m, bc, bv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float v = av * bv[j];
          const bool ok = m + j < nb && v != 0.f;
          dc[(m + j) * kt] = ok ? bc[j] : sent;
          dv[(m + j) * kt] = ok ? v : 0.f;
        }
      }
    }
    __syncthreads();
    store_run(gc, sc, n);
    store_run(reinterpret_cast<int*>(gv), reinterpret_cast<const int*>(sv), n);
  }
}

// Blocks of expand_kernel<V> resident on the current device at once (its
// SMs times the blocks one SM holds), asked of the runtime on a device's
// first launch and remembered per device.
template <int V>
cudaError_t expand_resident(long long* out) {
  static std::atomic<long long> cache[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) {
    return e;
  }
  if (dev < kMaxDevices && (*out = cache[dev].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_kernel<V>,
                                                      kBlock, kStageBytes);
  }
  if (e != cudaSuccess) {
    return e;
  }
  *out = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) {
    cache[dev].store(*out, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

template <int V>
int launch_expand(const int* a_cols, const float* a_vals, const int* a_nnz,
                  const int* b_cols, const float* b_vals, const int* b_nnz,
                  int* out_cols, float* out_vals, long long n_rows, int wa,
                  int wb, int sent, const ExpandPlan& p, cudaStream_t stream) {
  const long long n_tiles = (n_rows + p.rows - 1) / p.rows *
                            ((wb + p.m_span - 1) / p.m_span) *
                            ((wa + p.k_span - 1) / p.k_span);
  long long resident = 0;
  const cudaError_t e = expand_resident<V>(&resident);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  const auto blocks = static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  expand_kernel<V><<<blocks, kBlock, kStageBytes, stream>>>(
      a_cols, a_vals, a_nnz, b_cols, b_vals, b_nnz, out_cols, out_vals, n_rows,
      wa, wb, sent, p, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The merge's output modes.
enum Mode : int { kCount = 0, kInPlace = 1, kCompact = 2 };

constexpr int kMinTable = 64;
constexpr int kPrefetch = 4;  // candidate chunks loaded together
// a warp's table in shared memory up to this size: K ≤ 8192 in count mode,
// K ≤ 4096 in the others (97 KB a warp)
constexpr long long kMaxSharedTable = 100 * 1024;
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

// A warp's table: keys (SENT marks an empty slot: SENT slots are never
// inserted); outside count mode also each key's running sum, the row's live
// candidates staged in slot order and one bit per staged slot that marks
// the leaders.
__host__ __device__ inline long long warp_table_bytes(int mode, int K) {
  const long long t = table_size(K);
  return mode == kCount ? 4 * t : 8 * t + 8LL * K + 4 * ((K + 31) / 32);
}

// Fibonacci hashing: the top log2(T) bits of col·2^32/φ, which depend on
// every bit of col (columns equal modulo T spread out).
__device__ inline int hash_slot(int col, int shift) {
  return static_cast<int>((static_cast<unsigned>(col) * 0x9E3779B1u) >> shift);
}

// The slot of col in the table, inserted if absent; `inserted` tells
// whether this call's atomicCAS placed it.  A stale read of an empty key is
// harmless: the atomicCAS then returns the key that is there.
__device__ inline int find_or_insert(int* keys, int col, int shift, int tmask,
                                     int sent, bool& inserted) {
  int slot = hash_slot(col, shift);
  while (true) {
    const int key = keys[slot];
    if (key == col) {
      return slot;
    }
    if (key == sent) {
      const int old = atomicCAS(keys + slot, sent, col);
      if (old == sent) {
        inserted = true;
        return slot;
      }
      if (old == col) {
        return slot;
      }
    }
    slot = (slot + 1) & tmask;
  }
}

__device__ inline int find(const int* keys, int col, int shift, int tmask) {
  int slot = hash_slot(col, shift);
  while (keys[slot] != col) {
    slot = (slot + 1) & tmask;
  }
  return slot;
}

// One warp per row (grid-stride over rows), in mode M.  kShared: the tables
// are dynamic shared memory (the compiler then emits shared loads, stores
// and atomics); else `scratch` (global) holds one table per warp of the
// grid.  out_cols/out_vals are (n_rows, K) in place, (n_rows, out_width)
// compacted, unused in count mode.
template <int M, bool kShared>
__global__ void __launch_bounds__(kBlock)
    merge_kernel(const int* __restrict__ cand_cols,
                 const float* __restrict__ cand_vals, int* __restrict__ out_cols,
                 float* __restrict__ out_vals, int* __restrict__ counts,
                 long long n_rows, int K, int out_width, int sent,
                 char* scratch) {
  extern __shared__ __align__(16) char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tbytes = warp_table_bytes(M, K);
  char* base = kShared ? smem + warp * tbytes
                       : scratch + (static_cast<long long>(blockIdx.x) * warps + warp) * tbytes;
  const int tsize = table_size(K);
  const int tmask = tsize - 1;
  const int shift = 32 - (__ffs(tsize) - 1);
  int* keys = reinterpret_cast<int*>(base);
  float* sums = reinterpret_cast<float*>(keys + tsize);
  int* live_cols = reinterpret_cast<int*>(sums + tsize);
  float* live_vals = reinterpret_cast<float*>(live_cols + K);
  unsigned* leaders = reinterpret_cast<unsigned*>(live_vals + K);
  const int n_chunks = (K + 31) / 32;
  const unsigned below = (1u << lane) - 1u;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp;
       row < n_rows; row += static_cast<long long>(gridDim.x) * warps) {
    const int* rc = cand_cols + row * K;
    const float* rv = cand_vals + row * K;
    for (int i = lane; i < tsize; i += 32) {
      keys[i] = sent;
    }
    __syncwarp();
    int count = 0;
    if constexpr (M == kCount) {
      for (int c0 = 0; c0 < n_chunks; c0 += kPrefetch) {
        int cols[kPrefetch];
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const int j = (c0 + u) * 32 + lane;
          cols[u] = j < K ? __ldg(rc + j) : sent;
        }
        // every live lane inserts its own column: of the lanes that hold
        // one column, exactly one atomicCAS wins
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          bool inserted = false;
          if (cols[u] != sent) {
            find_or_insert(keys, cols[u], shift, tmask, sent, inserted);
          }
          count += __popc(__ballot_sync(kFull, inserted));
        }
      }
    } else {
      // stage the live candidates, compacted in slot order; kPrefetch
      // chunks' loads are in flight together
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
            live_cols[at] = cols[u];
            live_vals[at] = vals[u];
          }
          live += __popc(bits);
        }
      }
      __syncwarp();
      // pass 1: chunks in order, one lane per column and chunk, so each
      // sum runs in ascending slot order
      const int n_live = (live + 31) / 32;
      for (int c = 0; c < n_live; ++c) {
        const int j = c * 32 + lane;
        const int cj = j < live ? live_cols[j] : sent;
        const unsigned peers = __match_any_sync(kFull, cj);
        bool inserted = false;
        if (cj != sent && lane == __ffs(peers) - 1) {
          const int slot = find_or_insert(keys, cj, shift, tmask, sent, inserted);
          float sum = inserted ? 0.f : sums[slot];
          for (unsigned m = peers; m != 0u; m &= m - 1u) {
            sum = __fadd_rn(sum, live_vals[c * 32 + __ffs(m) - 1]);  // lane order
          }
          sums[slot] = sum;
        }
        const unsigned lead_bits = __ballot_sync(kFull, inserted);
        if (lane == 0) {
          leaders[c] = lead_bits;
        }
        count += __popc(lead_bits);
        __syncwarp();
      }
      if constexpr (M == kInPlace) {
        // pass 2: walk the slots again; a live slot's rank among the live
        // ones finds its leader bit
        int rank = 0;
        for (int c = 0; c < n_chunks; ++c) {
          const int j = c * 32 + lane;
          const int cj = j < K ? __ldg(rc + j) : sent;
          const unsigned bits = __ballot_sync(kFull, cj != sent);
          const int at = rank + __popc(bits & below);
          const bool lead = cj != sent && ((leaders[at >> 5] >> (at & 31)) & 1u) != 0u;
          if (j < K) {
            out_cols[row * K + j] = lead ? cj : sent;
            out_vals[row * K + j] = lead ? sums[find(keys, cj, shift, tmask)] : 0.f;
          }
          rank += __popc(bits);
        }
      } else {
        // pass 2: rank the leaders in slot order, write them, zeros after
        int rank = 0;
        for (int c = 0; c < n_live && rank < out_width; ++c) {
          const unsigned lead_bits = leaders[c];
          const int at = rank + __popc(lead_bits & below);
          if (((lead_bits >> lane) & 1u) != 0u && at < out_width) {
            const int cj = live_cols[c * 32 + lane];
            out_cols[row * out_width + at] = cj;
            out_vals[row * out_width + at] = sums[find(keys, cj, shift, tmask)];
          }
          rank += __popc(lead_bits);
        }
        for (int i = min(count, out_width) + lane; i < out_width; i += 32) {
          out_cols[row * out_width + i] = 0;
          out_vals[row * out_width + i] = 0.f;
        }
      }
    }
    if (lane == 0) {
      counts[row] = count;
    }
    __syncwarp();
  }
}

// Per-warp global scratch of a merge in `mode`: 0 where its table fits in
// shared memory.
long long scratch_bytes(int mode, int k) {
  const long long t = warp_table_bytes(mode, k);
  return t > kMaxSharedTable ? t : 0;
}

template <int M>
int launch_merge(const void* cand_cols, const void* cand_vals, void* out_cols,
                 void* out_vals, void* counts, long long n_rows, int k,
                 int out_width, int sent, void* scratch,
                 long long scratch_warps, void* stream) {
  if (n_rows <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const bool shared = scratch_bytes(M, k) == 0;
  if (k < 0 || k > kMaxK || (M == kCompact && out_width <= 0) ||
      (!shared && (scratch == nullptr || scratch_warps < kWarps))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const long long tbytes = warp_table_bytes(M, k);
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
    merge_kernel<M, false><<<blocks, warps * 32, 0, cs>>>(
        cc, cv, oc, ov, cnt, n_rows, k, out_width, sent,
        static_cast<char*>(scratch));
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_kernel<M, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
  }
  merge_kernel<M, true><<<blocks, warps * 32, smem, cs>>>(
      cc, cv, oc, ov, cnt, n_rows, k, out_width, sent, nullptr);
  return static_cast<int>(cudaGetLastError());
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
  if (n_rows <= 0 || wa <= 0 || wb <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  ExpandPlan p = expand_plan(wa, wb);
  // B's rows are read `vec` words at a time where its planes allow it
  const auto align = reinterpret_cast<unsigned long long>(b_cols) |
                     reinterpret_cast<unsigned long long>(b_vals);
  while (p.vec > 1 && align % (4 * p.vec) != 0) {
    p.vec /= 2;
  }
  const auto cs = static_cast<cudaStream_t>(stream);
  const auto* ac = static_cast<const int*>(a_cols);
  const auto* av = static_cast<const float*>(a_vals);
  const auto* an = static_cast<const int*>(a_nnz);
  const auto* bc = static_cast<const int*>(b_cols);
  const auto* bv = static_cast<const float*>(b_vals);
  const auto* bn = static_cast<const int*>(b_nnz);
  auto* oc = static_cast<int*>(out_cols);
  auto* ov = static_cast<float*>(out_vals);
  if (p.vec == 4) {
    return launch_expand<4>(ac, av, an, bc, bv, bn, oc, ov, n_rows, wa, wb, sent, p, cs);
  }
  if (p.vec == 2) {
    return launch_expand<2>(ac, av, an, bc, bv, bn, oc, ov, n_rows, wa, wb, sent, p, cs);
  }
  return launch_expand<1>(ac, av, an, bc, bv, bn, oc, ov, n_rows, wa, wb, sent, p, cs);
}

// B3's tiling for Wa and Wb (B's planes 16-byte-aligned): out[0..5] =
// rows a tile, m and k a tile, m a work item, B's load width in words,
// staging bytes a buffer (columns and values).
extern "C" void spgemm_expand_plan(int wa, int wb, long long* out) {
  const ExpandPlan p = expand_plan(wa > 0 ? wa : 1, wb > 0 ? wb : 1);
  const long long v[6] = {p.rows, p.m_span, p.k_span, p.m_group, p.vec,
                          2LL * kStageSlots * 4};
  for (int i = 0; i < 6; ++i) {
    out[i] = v[i];
  }
}

// Per-warp global scratch in bytes of a merge: mode 0 counts only, 1 in
// place (B5), 2 compact (B4); 0 where the warp's table fits in shared
// memory.
extern "C" long long spgemm_merge_scratch(int k, int mode) {
  return scratch_bytes(mode, k);
}

// B5: merge in place of slot; out_cols/out_vals may both be null (counts
// only).  Where spgemm_merge_scratch(k, mode) is not 0 the caller passes
// scratch_warps tables of that many bytes in `scratch`.
extern "C" int spgemm_dedup(const void* cand_cols, const void* cand_vals,
                            void* out_cols, void* out_vals, void* counts,
                            long long n_rows, int k, int sent, void* scratch,
                            long long scratch_warps, void* stream) {
  if (out_cols == nullptr) {
    return launch_merge<kCount>(cand_cols, cand_vals, nullptr, nullptr, counts,
                                n_rows, k, 0, sent, scratch, scratch_warps,
                                stream);
  }
  return launch_merge<kInPlace>(cand_cols, cand_vals, out_cols, out_vals,
                                counts, n_rows, k, 0, sent, scratch,
                                scratch_warps, stream);
}

// B4: merge and compact to (n_rows, out_width), with scratch as B5's.
extern "C" int spgemm_dedup_compact(const void* cand_cols,
                                    const void* cand_vals, void* out_cols,
                                    void* out_vals, void* counts,
                                    long long n_rows, int k, int out_width,
                                    int sent, void* scratch,
                                    long long scratch_warps, void* stream) {
  return launch_merge<kCompact>(cand_cols, cand_vals, out_cols, out_vals,
                                counts, n_rows, k, out_width, sent, scratch,
                                scratch_warps, stream);
}
