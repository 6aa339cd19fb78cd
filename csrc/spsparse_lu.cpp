// Native sparse LU for spsparse-tpu: Gilbert-Peierls left-looking
// factorization with partial pivoting over CSC input.
//
// Role in the architecture: factorization is sequential
// pointer-chasing (symbolic DFS reachability + per-column sparse
// triangular solves) and belongs on the host, exactly like the
// reference's host-side assembly loops; the *solves* against the
// resulting factors are what run on the device (level-scheduled fixed-point in
// solvers/direct.py). No counterpart exists in the reference
// (SURVEY.md §2 — spsparse has no direct solver); the API contract is
// scipy.sparse.linalg.splu's (SuperLU), implemented from the published
// Gilbert-Peierls algorithm (Gilbert & Peierls, "Sparse partial
// pivoting in time proportional to arithmetic operations", 1988).
//
// C ABI, handle-based (factor sizes are data-dependent): lu_factor
// returns an opaque handle; getters copy out CSC factors; lu_free
// releases. Consumed via ctypes (native/__init__.py pattern).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct LuFactors {
  int64_t n = 0;
  // L: unit lower triangular (unit diagonal NOT stored), CSC.
  std::vector<int64_t> l_colptr, l_rowind;
  std::vector<double> l_val;
  // U: upper triangular including diagonal, CSC.
  std::vector<int64_t> u_colptr, u_rowind;
  std::vector<double> u_val;
  // perm_r[i] = row of A used as pivot row for elimination step i
  // (i.e. PA row order); rows of L/U are in *pivoted* coordinates.
  std::vector<int64_t> perm_r;
};

}  // namespace

extern "C" {

// Factor A[:, perm_c] = P^T L U where P is the partial-pivot row
// permutation chosen greedily by max |value|.
//   n:        matrix dimension
//   colptr/rowind/val: CSC of A (nnz = colptr[n])
//   perm_c:   column order (length n; identity for NATURAL)
//   pivot_threshold: in [0,1]; 1.0 = classic partial pivoting, smaller
//     values allow keeping the diagonal entry when
//     |diag| >= threshold * max|col| (threshold pivoting).
//   drop_tol / max_keep_l / max_keep_u: ILUT controls (SuperLU-spilu
//     style). drop_tol > 0 drops U entries with |x| < drop_tol *
//     ||A[:,j]||_2 and L multipliers with |l| < drop_tol; max_keep_*
//     >= 0 additionally keeps only the largest-|.| entries per column
//     (the U diagonal always survives). drop_tol = 0, max_keep = -1
//     reproduces the exact factorization.
// Returns a handle (>0 cast of pointer) on success, 0 on singular or
// invalid input. Writes the zero-based index of the failing column to
// *info (or -1 on success).
void* spsparse_lu_factor_ex_f64(int64_t n, const int64_t* colptr,
                                const int64_t* rowind, const double* val,
                                const int64_t* perm_c,
                                double pivot_threshold, double drop_tol,
                                int64_t max_keep_l, int64_t max_keep_u,
                                int64_t* info) {
  *info = -1;
  if (n <= 0) { *info = 0; return nullptr; }
  auto* f = new LuFactors();
  f->n = n;
  f->l_colptr.assign(1, 0);
  f->u_colptr.assign(1, 0);
  f->perm_r.assign(n, -1);

  // pinv[orig_row] = elimination step at which that row became pivotal,
  // or -1 while still non-pivotal.
  std::vector<int64_t> pinv(n, -1);
  std::vector<double> x(n, 0.0);       // dense accumulator
  std::vector<int64_t> pattern;        // nonzero pattern of x (orig rows)
  pattern.reserve(64);
  std::vector<int64_t> stack(n), poststack;
  poststack.reserve(n);
  std::vector<int64_t> dfs_ptr(n);     // per-node resume position for DFS
  std::vector<uint8_t> mark(n, 0);
  std::vector<std::pair<int64_t, double>> ucand, lcand;  // per-column emit

  for (int64_t jj = 0; jj < n; ++jj) {
    const int64_t j = perm_c ? perm_c[jj] : jj;
    // ---- symbolic: reach of A[:, j]'s pattern through solved L columns
    // Topological order via iterative DFS with postorder collection.
    poststack.clear();
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
      int64_t r = rowind[p];
      if (mark[r]) continue;
      // DFS from r over the graph: node (orig row) r with pivot step
      // k = pinv[r] links to rows of L[:, k].
      int64_t top = 0;
      stack[top] = r;
      dfs_ptr[r] = (pinv[r] >= 0) ? f->l_colptr[pinv[r]] : -1;
      mark[r] = 1;
      while (top >= 0) {
        int64_t node = stack[top];
        int64_t k = pinv[node];
        bool descended = false;
        if (k >= 0) {
          int64_t& q = dfs_ptr[node];
          const int64_t qend = f->l_colptr[k + 1];
          while (q < qend) {
            int64_t child = f->l_rowind[q++];
            if (!mark[child]) {
              mark[child] = 1;
              stack[++top] = child;
              dfs_ptr[child] =
                  (pinv[child] >= 0) ? f->l_colptr[pinv[child]] : -1;
              descended = true;
              break;
            }
          }
        }
        if (!descended) {
          poststack.push_back(node);
          --top;
        }
      }
    }
    // Topological order for the numeric pass = reverse postorder.
    pattern.assign(poststack.rbegin(), poststack.rend());

    // ---- numeric: x = A[:, j]; sparse lower solve through pivotal cols
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
      x[rowind[p]] += val[p];
    for (int64_t t : pattern) {
      int64_t k = pinv[t];
      if (k < 0) continue;                       // non-pivotal: no update
      const double xk = x[t];
      if (xk == 0.0) continue;
      for (int64_t q = f->l_colptr[k]; q < f->l_colptr[k + 1]; ++q)
        x[f->l_rowind[q]] -= xk * f->l_val[q];
    }

    // ---- pivot among non-pivotal rows of the pattern
    double best = 0.0;
    int64_t piv = -1;
    double diag_candidate = 0.0;
    bool have_diag = false;
    for (int64_t t : pattern) {
      if (pinv[t] >= 0) continue;
      double a = std::fabs(x[t]);
      if (a > best) { best = a; piv = t; }
      if (t == j) { diag_candidate = a; have_diag = true; }
    }
    if (piv < 0 || best == 0.0) {            // structurally/numerically singular
      for (int64_t t : pattern) { x[t] = 0.0; mark[t] = 0; }
      *info = jj;
      delete f;
      return nullptr;
    }
    if (have_diag && diag_candidate >= pivot_threshold * best &&
        diag_candidate > 0.0)
      piv = j;                                // threshold: prefer diagonal
    const double pv = x[piv];
    pinv[piv] = jj;
    f->perm_r[jj] = piv;

    // ---- ILUT drop threshold for this column (scaled to ||A[:, j]||)
    double utol = 0.0;
    if (drop_tol > 0.0) {
      double s = 0.0;
      for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
        s += val[p] * val[p];
      utol = drop_tol * std::sqrt(s);
    }

    // ---- emit U (pivotal rows, in pivoted coordinates) and L (scaled)
    ucand.clear();
    lcand.clear();
    for (int64_t t : pattern) {
      if (pinv[t] >= 0 && t != piv) {
        if (x[t] != 0.0 && std::fabs(x[t]) >= utol)
          ucand.emplace_back(pinv[t], x[t]);
      } else if (pinv[t] < 0) {              // strictly-below-pivot rows
        const double lv2 = x[t] / pv;
        if (lv2 != 0.0 && std::fabs(lv2) >= drop_tol)
          lcand.emplace_back(t, lv2);        // orig row id (pivoted later)
      }
      // piv itself becomes the U diagonal below.
      x[t] = 0.0;
      mark[t] = 0;
    }
    auto cap_keep = [](std::vector<std::pair<int64_t, double>>& v,
                       int64_t keep) {
      if (keep >= 0 && static_cast<int64_t>(v.size()) > keep) {
        std::nth_element(v.begin(), v.begin() + keep, v.end(),
                         [](const auto& a, const auto& b) {
                           return std::fabs(a.second) > std::fabs(b.second);
                         });
        v.resize(keep);
      }
    };
    cap_keep(ucand, max_keep_u);
    cap_keep(lcand, max_keep_l);
    for (const auto& [r, v2] : ucand) {
      f->u_rowind.push_back(r);
      f->u_val.push_back(v2);
    }
    f->u_rowind.push_back(jj);               // diagonal of U, last in column
    f->u_val.push_back(pv);
    f->u_colptr.push_back(static_cast<int64_t>(f->u_rowind.size()));
    for (const auto& [r, v2] : lcand) {
      f->l_rowind.push_back(r);
      f->l_val.push_back(v2);
    }
    f->l_colptr.push_back(static_cast<int64_t>(f->l_rowind.size()));
  }
  // L row ids are original rows; remap to pivoted coordinates now that
  // every row has a pivot step.
  for (auto& r : f->l_rowind) r = pinv[r];
  return f;
}

// Exact-LU convenience wrapper (original entry point).
void* spsparse_lu_factor_f64(int64_t n, const int64_t* colptr,
                             const int64_t* rowind, const double* val,
                             const int64_t* perm_c, double pivot_threshold,
                             int64_t* info) {
  return spsparse_lu_factor_ex_f64(n, colptr, rowind, val, perm_c,
                                   pivot_threshold, 0.0, -1, -1, info);
}

int64_t spsparse_lu_nnz_l(void* h) {
  return static_cast<LuFactors*>(h)->l_rowind.size();
}
int64_t spsparse_lu_nnz_u(void* h) {
  return static_cast<LuFactors*>(h)->u_rowind.size();
}

// Copy factors out (caller allocates to the sizes above; colptr length
// n+1, perm_r length n). L excludes its unit diagonal.
void spsparse_lu_get(void* h, int64_t* l_colptr, int64_t* l_rowind,
                     double* l_val, int64_t* u_colptr, int64_t* u_rowind,
                     double* u_val, int64_t* perm_r) {
  auto* f = static_cast<LuFactors*>(h);
  std::memcpy(l_colptr, f->l_colptr.data(),
              sizeof(int64_t) * f->l_colptr.size());
  std::memcpy(l_rowind, f->l_rowind.data(),
              sizeof(int64_t) * f->l_rowind.size());
  std::memcpy(l_val, f->l_val.data(), sizeof(double) * f->l_val.size());
  std::memcpy(u_colptr, f->u_colptr.data(),
              sizeof(int64_t) * f->u_colptr.size());
  std::memcpy(u_rowind, f->u_rowind.data(),
              sizeof(int64_t) * f->u_rowind.size());
  std::memcpy(u_val, f->u_val.data(), sizeof(double) * f->u_val.size());
  std::memcpy(perm_r, f->perm_r.data(), sizeof(int64_t) * f->perm_r.size());
}

void spsparse_lu_free(void* h) { delete static_cast<LuFactors*>(h); }

// Sequential CSC triangular solve on the host: overwrite b with the
// solution of T x = b. lower != 0 => forward substitution (columns
// ascending), else backward. unit_diag != 0 => diagonal implicitly 1
// and any stored diagonal entries are ignored. Diagonal entries, when
// used, must be present and positioned anywhere within their column.
// Returns -1 on success or the zero-based column with a missing/zero
// diagonal.
int64_t spsparse_trisolve_csc_f64(int64_t n, const int64_t* colptr,
                                  const int64_t* rowind, const double* val,
                                  int32_t lower, int32_t unit_diag,
                                  double* b, int64_t nrhs,
                                  int64_t ldb /* stride between rhs */) {
  for (int64_t r = 0; r < nrhs; ++r) {
    double* x = b + r * ldb;
    if (lower) {
      for (int64_t j = 0; j < n; ++j) {
        double d = 1.0;
        if (!unit_diag) {
          d = 0.0;
          for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
            if (rowind[p] == j) { d = val[p]; break; }
          if (d == 0.0) return j;
        }
        const double xj = x[j] / d;
        x[j] = xj;
        if (xj != 0.0)
          for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
            if (rowind[p] > j) x[rowind[p]] -= val[p] * xj;
      }
    } else {
      for (int64_t j = n - 1; j >= 0; --j) {
        double d = 1.0;
        if (!unit_diag) {
          d = 0.0;
          for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
            if (rowind[p] == j) { d = val[p]; break; }
          if (d == 0.0) return j;
        }
        const double xj = x[j] / d;
        x[j] = xj;
        if (xj != 0.0)
          for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
            if (rowind[p] < j) x[rowind[p]] -= val[p] * xj;
      }
    }
  }
  return -1;
}

}  // extern "C"
