// Native host-side runtime components (SURVEY.md §2 native checklist).
//
// The TPU compute path is Pallas/XLA; these are the host-side pieces that
// the reference implements natively (C++) and that are hot on the SETUP
// path for large problems:
//   1. bell_from_csr   — CSR -> blocked-ELL conversion (SURVEY C3)
//   2. level_schedule  — dependency levels for parallel triangular solves
//                        (SURVEY C10; consumed by kernels/tri_solve.py)
//   3. ldlt_*          — sparse LDL^T factorization (up-looking, etree
//                        reach; the classic Davis LDL algorithm re-derived)
//                        (SURVEY C10: "sparse factorization path")
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. CSR -> blocked-ELL.
// Inputs: CSR of the n x n matrix (n padded to a multiple of b by caller:
// indptr has n+1 entries and rows >= logical size are empty).
// Outputs: blocks (nbr*S*b*b) zero-initialised by caller, cols (nbr*S)
// zero-initialised. Returns max blocks/row actually used, or -1 if it
// exceeds S.
// ---------------------------------------------------------------------------
int64_t bell_from_csr(int64_t n, int64_t b, int64_t S,
                      const int64_t* indptr, const int32_t* indices,
                      const double* data, double* blocks, int32_t* cols) {
  const int64_t nbr = n / b;
  std::vector<int32_t> slot_of_bcol(nbr, -1);  // per block-row scratch
  std::vector<int32_t> used;                   // touched block-cols
  int64_t max_used = 0;
  for (int64_t br = 0; br < nbr; ++br) {
    used.clear();
    double* brow_blocks = blocks + br * S * b * b;
    int32_t* brow_cols = cols + br * S;
    int64_t nslots = 0;
    for (int64_t r = br * b; r < (br + 1) * b; ++r) {
      const int64_t ri = r - br * b;
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int32_t c = indices[p];
        const int32_t bc = c / (int32_t)b;
        int32_t s = slot_of_bcol[bc];
        if (s < 0) {
          if (nslots >= S) return -1;
          s = (int32_t)nslots++;
          slot_of_bcol[bc] = s;
          brow_cols[s] = bc;
          used.push_back(bc);
        }
        brow_blocks[(int64_t)s * b * b + ri * b + (c - (int64_t)bc * b)] =
            data[p];
      }
    }
    if (nslots > max_used) max_used = nslots;
    for (int32_t bc : used) slot_of_bcol[bc] = -1;
  }
  return max_used;
}

// ---------------------------------------------------------------------------
// 2. Level schedule for a triangular CSR matrix.
// lower != 0: forward order (deps = cols < row); else backward (cols > row).
// out_level[i] = dependency level of row i. Returns number of levels.
// ---------------------------------------------------------------------------
int64_t level_schedule(int64_t n, const int64_t* indptr,
                       const int32_t* indices, int lower,
                       int64_t* out_level) {
  int64_t nlevels = 0;
  if (lower) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t lev = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int32_t c = indices[p];
        if (c < i && out_level[c] + 1 > lev) lev = out_level[c] + 1;
      }
      out_level[i] = lev;
      if (lev + 1 > nlevels) nlevels = lev + 1;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t lev = 0;
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
        const int32_t c = indices[p];
        if (c > i && out_level[c] + 1 > lev) lev = out_level[c] + 1;
      }
      out_level[i] = lev;
      if (lev + 1 > nlevels) nlevels = lev + 1;
    }
  }
  return nlevels;
}

// ---------------------------------------------------------------------------
// 3. Sparse LDL^T (up-looking, no pivoting — caller pre-orders for fill and
// falls back to pivoted LU on breakdown).
//
// Input: the UPPER triangle of symmetric A in CSC (equivalently the lower
// triangle in CSR), diagonal included.
// Phase 1 (ldlt_symbolic): elimination tree + column counts.
//   parent (n), lnz_counts (n) outputs; returns total nnz(L) (excluding
//   the unit diagonal).
// Phase 2 (ldlt_numeric): fills Lp (n+1, precomputed by caller from
//   lnz_counts), Li, Lx, D. Returns k >= 0 of a zero pivot (failure) or -1
//   on success.
// ---------------------------------------------------------------------------
int64_t ldlt_symbolic(int64_t n, const int64_t* Ap, const int32_t* Ai,
                      int64_t* parent, int64_t* lnz_counts) {
  std::vector<int64_t> flag(n);
  int64_t total = 0;
  for (int64_t k = 0; k < n; ++k) {
    parent[k] = -1;
    flag[k] = k;
    lnz_counts[k] = 0;
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int64_t i = Ai[p];  // i <= k (upper triangle, CSC col k)
      // walk from i up to the root of the current etree
      for (; i < k && flag[i] != k; i = parent[i]) {
        if (parent[i] == -1) parent[i] = k;
        lnz_counts[i]++;  // L(k, i) will be nonzero
        total++;
        flag[i] = k;
      }
    }
  }
  return total;
}

int64_t ldlt_numeric(int64_t n, const int64_t* Ap, const int32_t* Ai,
                     const double* Ax, const int64_t* parent,
                     const int64_t* Lp, int32_t* Li, double* Lx, double* D) {
  std::vector<double> y(n, 0.0);
  std::vector<int64_t> pattern(n), flag(n, -1), lnz(n, 0);
  for (int64_t k = 0; k < n; ++k) {
    // scatter column k of A (upper triangle) into y; build reach pattern
    int64_t top = n;
    flag[k] = k;
    D[k] = 0.0;
    for (int64_t p = Ap[k]; p < Ap[k + 1]; ++p) {
      int64_t i = Ai[p];
      if (i > k) continue;
      y[i] += Ax[p];
      int64_t len = 0;
      for (; flag[i] != k; i = parent[i]) {
        pattern[len++] = i;
        flag[i] = k;
      }
      while (len > 0) pattern[--top] = pattern[--len];
    }
    D[k] = y[k];
    y[k] = 0.0;
    // sparse triangular solve along the pattern (ascending etree order)
    for (int64_t t = top; t < n; ++t) {
      const int64_t i = pattern[t];
      const double yi = y[i];
      y[i] = 0.0;
      const double di = D[i];
      if (di == 0.0) return i;
      const double lki = yi / di;
      // y -= L(:,i) * yi for rows below i in pattern
      for (int64_t p = Lp[i]; p < Lp[i] + lnz[i]; ++p) {
        y[Li[p]] -= Lx[p] * yi;
      }
      D[k] -= lki * yi;
      // append L(k, i)
      Li[Lp[i] + lnz[i]] = (int32_t)k;
      Lx[Lp[i] + lnz[i]] = lki;
      lnz[i]++;
    }
    if (D[k] == 0.0) return k;
  }
  return -1;
}

}  // extern "C"
