// Native setup-phase builder for PCSR distribution (SURVEY.md §2.1/§2.7).
//
// The port's copy of parallel_amg_tpu/native/pcsr_builder.cpp: the O(nnz)
// row-scan passes that partition a global CSR matrix into per-part
// own/ghost padded ELL blocks, two linear scans parallelized over parts with
// OpenMP, invoked from Python through ctypes
// (parallel_amg_tpu_torch/native/__init__.py).
//
// Semantics mirror parallel_amg_tpu_torch/parallel/pcsr.py::PCSR.from_csr
// exactly, including the clamped owner rule owner(g) = min(g / mc, S-1)
// of partition.py::Partition.owner_of.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

inline int64_t owner_of(int64_t gid, int64_t mc, int64_t S) {
  int64_t o = gid / mc;
  return o < S - 1 ? o : S - 1;
}

}  // namespace

extern "C" {

// Pass 1 — per-shard analysis: max own/off entries per row (ELL widths) and
// the sorted-unique ghost (off-owner) column set of every shard, written
// concatenated into ghost_gids with prefix offsets ghost_off[S+1].
// Returns 0, or -1 if ghost_cap (caller-provided capacity, nnz is always
// enough) would be exceeded.
int pcsr_analyze(const int64_t* indptr, const int64_t* indices,
                 int64_t n_rows, int64_t S, int64_t m, int64_t mc,
                 int32_t* Wd_out, int32_t* Wo_out, int64_t* ghost_off,
                 int64_t* ghost_gids, int64_t ghost_cap) {
  std::vector<std::vector<int64_t>> ghosts(S);
  std::vector<int32_t> wd(S, 0), wo(S, 0);

#pragma omp parallel for schedule(dynamic)
  for (int64_t s = 0; s < S; ++s) {
    int64_t lo = std::min(s * m, n_rows);
    int64_t hi = std::min((s + 1) * m, n_rows);
    std::vector<int64_t>& g = ghosts[s];
    for (int64_t i = lo; i < hi; ++i) {
      int32_t nd = 0, no = 0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        int64_t c = indices[k];
        if (owner_of(c, mc, S) == s) {
          ++nd;
        } else {
          ++no;
          g.push_back(c);
        }
      }
      wd[s] = std::max(wd[s], nd);
      wo[s] = std::max(wo[s], no);
    }
    std::sort(g.begin(), g.end());
    g.erase(std::unique(g.begin(), g.end()), g.end());
  }

  int64_t off = 0;
  ghost_off[0] = 0;
  for (int64_t s = 0; s < S; ++s) {
    if (off + (int64_t)ghosts[s].size() > ghost_cap) return -1;
    std::copy(ghosts[s].begin(), ghosts[s].end(), ghost_gids + off);
    off += ghosts[s].size();
    ghost_off[s + 1] = off;
  }
  *Wd_out = *std::max_element(wd.begin(), wd.end());
  *Wo_out = *std::max_element(wo.begin(), wo.end());
  return 0;
}

// Pass 2 — fill the padded ELL planes.  diag_cols/off_cols hold local /
// ghost-slot indices; ghost slots resolve by binary search into the shard's
// sorted ghost list from pass 1.  Output arrays are caller-zero-initialized
// (S, m, Wd|Wo); identity padding rows are appended by the Python wrapper.
int pcsr_fill(const int64_t* indptr, const int64_t* indices,
              const double* data, int64_t n_rows, int64_t S, int64_t m,
              int64_t mc, int32_t Wd, int32_t Wo, const int64_t* ghost_off,
              const int64_t* ghost_gids, int32_t* diag_cols,
              double* diag_vals, int32_t* off_cols, double* off_vals) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t s = 0; s < S; ++s) {
    int64_t lo = std::min(s * m, n_rows);
    int64_t hi = std::min((s + 1) * m, n_rows);
    const int64_t* gbeg = ghost_gids + ghost_off[s];
    const int64_t* gend = ghost_gids + ghost_off[s + 1];
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = i - s * m;
      int32_t* dc = diag_cols + (s * m + r) * Wd;
      double* dv = diag_vals + (s * m + r) * Wd;
      int32_t* oc = off_cols + (s * m + r) * Wo;
      double* ov = off_vals + (s * m + r) * Wo;
      int32_t nd = 0, no = 0;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
        int64_t c = indices[k];
        if (owner_of(c, mc, S) == s) {
          dc[nd] = (int32_t)(c - s * mc);
          dv[nd] = data[k];
          ++nd;
        } else {
          oc[no] = (int32_t)(std::lower_bound(gbeg, gend, c) - gbeg);
          ov[no] = data[k];
          ++no;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
