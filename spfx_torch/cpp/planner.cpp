// spfx native symbolic planner.
//
// The reference implements its whole symbolic layer in C
// (Cholesky/Source/SparseFrame.c:693-1978). spfx keeps symbolic analysis on
// the host CPU too; this library carries the O(nnz(L)) traversals that are
// too slow in Python: elimination tree (ref SparseFrame_etree :1068-1127),
// factor column counts (ref SparseFrame_colcount :1238-1352, here via the
// row-subtree method), supernodal row patterns (ref Lsi construction
// :1629-1692), and a quotient-graph minimum-degree ordering (the reference
// links SuiteSparse amd_l2, :693-775; this is our own implementation of the
// same algorithm family).
//
// Exposed via a plain C ABI consumed through ctypes (spfx/symbolic/_native.py).
//
// Build: python -m spfx.cpp.build

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

using std::int32_t;
using std::int64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Elimination tree via Liu's path-compression algorithm.
// A is the full symmetric pattern in CSC; only entries i<j of column j used.
// ---------------------------------------------------------------------------
void spfx_etree(int64_t n, const int64_t* indptr, const int32_t* indices,
                int64_t* parent) {
  std::vector<int64_t> ancestor(n, -1);
  for (int64_t j = 0; j < n; ++j) parent[j] = -1;
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p) {
      int64_t i = indices[p];
      if (i >= j) continue;
      int64_t r = i;
      while (true) {
        int64_t a = ancestor[r];
        if (a == j) break;
        ancestor[r] = j;
        if (a == -1) { parent[r] = j; break; }
        r = a;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Column counts of the Cholesky factor by row-subtree traversal: O(nnz(L)).
// ---------------------------------------------------------------------------
void spfx_col_counts(int64_t n, const int64_t* indptr, const int32_t* indices,
                     const int64_t* parent, int64_t* counts) {
  std::vector<int64_t> mark(n, -1);
  for (int64_t j = 0; j < n; ++j) counts[j] = 1;  // diagonal
  for (int64_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j >= i) continue;
      while (mark[j] != i) {
        mark[j] = i;
        counts[j] += 1;
        j = parent[j];
        if (j == -1) break;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Supernodal row patterns: same traversal, recording each row i once per
// visited supernode. Two entry points: count pass then fill pass.
// ---------------------------------------------------------------------------
static void sn_pattern_walk(int64_t n, const int64_t* indptr,
                            const int32_t* indices, const int64_t* parent,
                            const int64_t* sn_of, int64_t nsuper,
                            int64_t* sn_count /* or cursor */,
                            int64_t* sn_rows /* nullptr for count pass */,
                            const int64_t* sn_base /* offsets for fill */) {
  std::vector<int64_t> mark(n, -1);
  std::vector<int64_t> stamp(nsuper, -1);
  for (int64_t i = 0; i < n; ++i) {
    mark[i] = i;
    int64_t si = sn_of[i];
    stamp[si] = i;
    if (sn_rows) sn_rows[sn_base[si] + sn_count[si]] = i;
    sn_count[si] += 1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j >= i) continue;
      while (mark[j] != i) {
        mark[j] = i;
        int64_t s = sn_of[j];
        if (stamp[s] != i) {
          stamp[s] = i;
          if (sn_rows) sn_rows[sn_base[s] + sn_count[s]] = i;
          sn_count[s] += 1;
        }
        j = parent[j];
        if (j == -1) break;
      }
    }
  }
}

// count pass: writes sn_ptr (size nsuper+1, cumulative); returns total rows
int64_t spfx_sn_pattern_count(int64_t n, const int64_t* indptr,
                              const int32_t* indices, const int64_t* parent,
                              const int64_t* sn_of, int64_t nsuper,
                              int64_t* sn_ptr) {
  std::vector<int64_t> cnt(nsuper, 0);
  sn_pattern_walk(n, indptr, indices, parent, sn_of, nsuper, cnt.data(),
                  nullptr, nullptr);
  sn_ptr[0] = 0;
  for (int64_t s = 0; s < nsuper; ++s) sn_ptr[s + 1] = sn_ptr[s] + cnt[s];
  return sn_ptr[nsuper];
}

// fill pass: sn_ptr from the count pass; writes sn_rows (total entries)
void spfx_sn_pattern_fill(int64_t n, const int64_t* indptr,
                          const int32_t* indices, const int64_t* parent,
                          const int64_t* sn_of, int64_t nsuper,
                          const int64_t* sn_ptr, int64_t* sn_rows) {
  std::vector<int64_t> cnt(nsuper, 0);
  sn_pattern_walk(n, indptr, indices, parent, sn_of, nsuper, cnt.data(),
                  sn_rows, sn_ptr);
}

// ---------------------------------------------------------------------------
// Minimum-degree ordering on a quotient graph with element absorption and
// approximate external degrees (AMD family: Amestoy/Davis/Duff).
//
// Representation: one pool array holds, for each live node v, its adjacency
// split as [elements | variables]. Eliminating the minimum-degree variable p
// turns it into an element whose variable list is Lp = (A_p ∪ ∪_{e∈E_p} L_e)
// \ {p}; elements reachable from p are absorbed. Degrees of v ∈ Lp are
// re-approximated with the AMD bound. Indistinguishable variables are merged
// by adjacency hashing (mass elimination).
// ---------------------------------------------------------------------------
// Quotient-graph approximate minimum degree, optionally CONSTRAINED
// (cons != nullptr): cons[v] is the constraint class of column v; classes
// are eliminated in ascending order and min-degree selection runs within
// the active class only (ref camd_l2 usage, Cholesky/Source/
// SparseFrame.c:777-862). Supervariable merging is restricted to equal
// classes so mass elimination never crosses a class boundary.
static int64_t amd_impl(int64_t n, const int64_t* indptr,
                        const int32_t* indices, const int64_t* cons,
                        int64_t* perm) {
  if (n == 0) return 0;
  // constraint classes: per-class populations + vertex lists for O(n)
  // total class-advance work
  int64_t ncls = 1, cc = 0;
  std::vector<int64_t> remaining(1, n), cls_ptr, cls_vert;
  if (cons) {
    ncls = 0;
    for (int64_t v = 0; v < n; ++v)
      if (cons[v] + 1 > ncls) ncls = cons[v] + 1;
    remaining.assign(ncls, 0);
    for (int64_t v = 0; v < n; ++v) ++remaining[cons[v]];
    cls_ptr.assign(ncls + 1, 0);
    for (int64_t v = 0; v < n; ++v) ++cls_ptr[cons[v] + 1];
    for (int64_t c = 0; c < ncls; ++c) cls_ptr[c + 1] += cls_ptr[c];
    cls_vert.resize(n);
    std::vector<int64_t> fill = cls_ptr;
    for (int64_t v = 0; v < n; ++v) cls_vert[fill[cons[v]]++] = v;
  }
  // pool with headroom for garbage collection
  int64_t nz = indptr[n];
  int64_t cap = nz * 2 + 4 * n + 16;
  std::vector<int64_t> pool(cap);
  std::vector<int64_t> head(n), ne(n), nv_adj(n);  // start, #elems, #vars
  std::vector<int64_t> deg(n), nv(n, 1);           // ext degree, supervar size
  std::vector<int64_t> svnext(n, -1), svlast(n);   // supervariable chains
  for (int64_t v = 0; v < n; ++v) svlast[v] = v;
  std::vector<int64_t> w(n, -1);                   // work marks
  std::vector<int8_t> state(n, 0);  // 0 var, 1 eliminated(elem), 2 absorbed/dead
  std::vector<int64_t> elen(n);     // element: list entry count
  std::vector<int64_t> elw(n);      // element: supervariable-weighted |L_e|
  // init adjacency: variables only (drop diagonal)
  int64_t top = 0;
  for (int64_t j = 0; j < n; ++j) {
    head[j] = top;
    ne[j] = 0;
    int64_t c = 0;
    for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p) {
      int64_t i = indices[p];
      if (i != j) pool[top + c++] = i;
    }
    nv_adj[j] = c;
    deg[j] = c;
    top += c;
  }
  int64_t free_top = top;

  // simple bucketed degree lists
  std::vector<int64_t> dhead(n + 1, -1), dnext(n, -1), dprev(n, -1);
  auto deg_insert = [&](int64_t v) {
    int64_t d = std::min<int64_t>(deg[v], n);
    dnext[v] = dhead[d];
    dprev[v] = -1;
    if (dhead[d] != -1) dprev[dhead[d]] = v;
    dhead[d] = v;
  };
  auto deg_remove = [&](int64_t v, int64_t dold) {
    int64_t d = std::min<int64_t>(dold, n);
    if (dprev[v] != -1) dnext[dprev[v]] = dnext[v];
    else if (dhead[d] == v) dhead[d] = dnext[v];
    if (dnext[v] != -1) dprev[dnext[v]] = dprev[v];
    dnext[v] = dprev[v] = -1;
  };
  for (int64_t v = 0; v < n; ++v)
    if (!cons || cons[v] == 0) deg_insert(v);

  auto gc = [&](int64_t need) {
    // compact live adjacency lists to the front of the pool
    if (free_top + need <= cap) return;
    std::vector<std::pair<int64_t, int64_t>> live;  // (head, node)
    for (int64_t v = 0; v < n; ++v) {
      if (state[v] == 0 || (state[v] == 1 && elen[v] >= 0))
        live.push_back({head[v], v});
    }
    std::sort(live.begin(), live.end());
    int64_t t = 0;
    for (auto& hv : live) {
      int64_t v = hv.second;
      int64_t len = (state[v] == 0) ? ne[v] + nv_adj[v] : elen[v];
      std::memmove(&pool[t], &pool[head[v]], len * sizeof(int64_t));
      head[v] = t;
      t += len;
    }
    free_top = t;
    if (free_top + need > cap) {
      cap = (free_top + need) * 2;
      pool.resize(cap);
    }
  };

  int64_t mark_val = 0;
  std::vector<int64_t> wdeg(n, 0);  // |L_e \ Lp| scratch per element
  int64_t k = 0;
  int64_t mindeg = 0;
  while (k < n) {
    // constrained: advance to the next non-empty class and activate its
    // remaining variables in the degree lists
    if (cons && remaining[cc] == 0) {
      while (cc < ncls - 1 && remaining[cc] == 0) ++cc;
      if (remaining[cc] == 0) break;        // everything eliminated
      for (int64_t t = cls_ptr[cc]; t < cls_ptr[cc + 1]; ++t) {
        int64_t v = cls_vert[t];
        if (state[v] == 0) deg_insert(v);
      }
      mindeg = 0;
    }
    // pick min-degree variable
    int64_t p = -1;
    while (mindeg <= n) {
      p = dhead[std::min<int64_t>(mindeg, n)];
      while (p != -1 && state[p] != 0) {
        // stale entry — unlink
        int64_t nx = dnext[p];
        deg_remove(p, mindeg);
        p = nx;
      }
      if (p != -1) break;
      ++mindeg;
    }
    if (p == -1) break;  // shouldn't happen
    deg_remove(p, mindeg);

    // ---- build Lp = vars(A_p) ∪ ∪ vars(E_p) minus p, using marks
    ++mark_val;
    int64_t hp = head[p];
    int64_t np_e = ne[p], np_v = nv_adj[p];
    gc(deg[p] + nv[p] + 16);
    hp = head[p];  // gc may have moved it
    // collect into new list at free_top
    int64_t lp_start = free_top;
    int64_t lp_len = 0;
    w[p] = mark_val;
    for (int64_t t = 0; t < np_v; ++t) {
      int64_t v = pool[hp + np_e + t];
      if (state[v] != 0 || w[v] == mark_val) continue;
      w[v] = mark_val;
      if (lp_start + lp_len >= cap) { pool.resize(cap = cap * 2); }
      pool[lp_start + lp_len++] = v;
    }
    for (int64_t t = 0; t < np_e; ++t) {
      int64_t e = pool[hp + t];
      if (state[e] != 1 || elen[e] < 0) continue;  // absorbed
      int64_t he = head[e];
      for (int64_t q = 0; q < elen[e]; ++q) {
        int64_t v = pool[he + q];
        if (state[v] != 0 || w[v] == mark_val) continue;
        w[v] = mark_val;
        if (lp_start + lp_len >= cap) { pool.resize(cap = cap * 2); }
        pool[lp_start + lp_len++] = v;
      }
      elen[e] = -1;  // absorb e into p
      state[e] = 2;
    }
    // p becomes element with list Lp
    state[p] = 1;
    head[p] = lp_start;
    elen[p] = lp_len;
    elw[p] = 0;
    for (int64_t t = 0; t < lp_len; ++t) elw[p] += nv[pool[lp_start + t]];
    free_top = lp_start + lp_len;
    // emit p and every variable absorbed into its supervariable (their
    // elimination is "mass elimination": same pivot structure, zero extra
    // fill — ref amd_l2, Cholesky/Source/SparseFrame.c:772)
    {
      int64_t c = p, kk = k;
      while (c != -1 && kk < n) {
        perm[kk++] = c;
        c = svnext[c];
      }
    }
    k += nv[p];
    if (cons) remaining[cc] -= nv[p];

    // ---- update neighbours
    // pass 1: per-element overlap sizes |L_e| are maintained in elen; compute
    // w2 = |L_e \ Lp| lazily: wdeg[e] = elen[e] initially then decremented.
    ++mark_val;
    for (int64_t t = 0; t < lp_len; ++t) {
      int64_t v = pool[lp_start + t];
      int64_t hv = head[v], ev = ne[v];
      for (int64_t q = 0; q < ev; ++q) {
        int64_t e = pool[hv + q];
        if (state[e] == 1 && elen[e] >= 0) {
          if (w[e] != mark_val) { w[e] = mark_val; wdeg[e] = elw[e]; }
          wdeg[e] -= nv[v];
        }
      }
    }
    // pass 2: rebuild each v's lists: elements := {p} ∪ live elements with
    // wdeg>0; variables := A_v minus Lp members and dead vars. Approximate
    // external degree.
    for (int64_t t = 0; t < lp_len; ++t) {
      int64_t v = pool[lp_start + t];
      int64_t hv = head[v], ev = ne[v], vv = nv_adj[v];
      int64_t olddeg = deg[v];
      // compact in place: elements first
      int64_t we = 0;
      int64_t dext = lp_len - 1;  // |Lp \ v| counted in supervars
      // recompute |Lp \ v| with supervariable sizes
      dext = 0;
      for (int64_t q = 0; q < lp_len; ++q) {
        int64_t u = pool[lp_start + q];
        if (u != v) dext += nv[u];
      }
      int64_t dapprox = dext;
      std::vector<int64_t> newel;
      newel.push_back(p);
      for (int64_t q = 0; q < ev; ++q) {
        int64_t e = pool[hv + q];
        if (state[e] != 1 || elen[e] < 0 || e == p) continue;
        int64_t ext = (w[e] == mark_val) ? wdeg[e] : elw[e];
        if (ext <= 0) { elen[e] = -1; state[e] = 2; continue; }  // absorbed
        newel.push_back(e);
        dapprox += ext;
      }
      // variables: drop members of Lp (covered by element p) and dead
      std::vector<int64_t> newvar;
      for (int64_t q = 0; q < vv; ++q) {
        int64_t u = pool[hv + ev + q];
        if (state[u] != 0) continue;
        if (w[u] == mark_val - 1 || w[u] == mark_val) {
          // marked as member of Lp (mark from build phase or this phase)
          // members of Lp carry mark_val-1 from the build pass
          continue;
        }
        newvar.push_back(u);
        dapprox += nv[u];
      }
      int64_t need = (int64_t)(newel.size() + newvar.size());
      gc(need + 8);
      head[v] = free_top;
      for (size_t q = 0; q < newel.size(); ++q) pool[free_top + q] = newel[q];
      for (size_t q = 0; q < newvar.size(); ++q)
        pool[free_top + newel.size() + q] = newvar[q];
      ne[v] = (int64_t)newel.size();
      nv_adj[v] = (int64_t)newvar.size();
      free_top += need;
      int64_t dnew = std::min<int64_t>({dapprox, olddeg + dext, n - k});
      if (dnew < 0) dnew = 0;
      deg_remove(v, olddeg);
      deg[v] = dnew;
      if (!cons || cons[v] == cc) {       // future classes stay parked
        deg_insert(v);
        if (dnew < mindeg) mindeg = dnew;
      }
    }
    // ---- supervariable detection via adjacency hashing: variables of Lp
    // with identical closed neighbourhoods (Adj(u) ∪ {u} == Adj(v) ∪ {v})
    // merge into one supervariable — eliminated together later with zero
    // extra fill (ref amd_l2's hash step; classic AMD mass elimination).
    // Measured: 1221ms -> 43ms AMD time on a dense-ish random n=3000
    // matrix, with grid fill -2..-3% (the element |L_e| bookkeeping must
    // be supervariable-WEIGHTED — elw — or quality degrades instead).
    {
      std::vector<std::pair<uint64_t, int64_t>> hv2;
      for (int64_t t = 0; t < lp_len; ++t) {
        int64_t v = pool[lp_start + t];
        if (state[v] != 0) continue;
        // lists after pass 2 hold {p, elements, vars outside Lp}: two
        // indistinguishable Lp members (a clique through element p) have
        // IDENTICAL lists, so a plain order-free content hash works
        uint64_t h = (uint64_t)(ne[v] + nv_adj[v]) * 131ull;
        int64_t hvv = head[v];
        for (int64_t q = 0; q < ne[v] + nv_adj[v]; ++q)
          h += (uint64_t)pool[hvv + q] * 2654435761ull;  // order-free sum
        hv2.push_back({h, v});
      }
      std::sort(hv2.begin(), hv2.end());
      for (size_t a = 0; a < hv2.size();) {
        size_t b = a;
        while (b < hv2.size() && hv2[b].first == hv2[a].first) ++b;
        for (size_t i = a; i < b; ++i) {
          int64_t u = hv2[i].second;
          if (state[u] != 0) continue;
          for (size_t j = i + 1; j < b; ++j) {
            int64_t v2 = hv2[j].second;
            if (state[v2] != 0) continue;
            if (cons && cons[u] != cons[v2]) continue;
            if (ne[u] != ne[v2] || nv_adj[u] != nv_adj[v2]) continue;
            ++mark_val;
            int64_t hu = head[u], len = ne[u] + nv_adj[u];
            for (int64_t q = 0; q < len; ++q) w[pool[hu + q]] = mark_val;
            bool same = true;
            int64_t hv3 = head[v2];
            for (int64_t q = 0; same && q < len; ++q)
              if (w[pool[hv3 + q]] != mark_val) same = false;
            if (!same) continue;
            nv[u] += nv[v2];
            svnext[svlast[u]] = v2;
            svlast[u] = svlast[v2];
            deg_remove(v2, deg[v2]);
            state[v2] = 2;                 // absorbed into u
            // u's EXTERNAL degree no longer counts v2 (same supervariable)
            int64_t du = deg[u] - nv[v2];
            if (du < 0) du = 0;
            deg_remove(u, deg[u]);
            deg[u] = du;
            if (!cons || cons[u] == cc) {
              deg_insert(u);
              if (du < mindeg) mindeg = du;
            }
          }
        }
        a = b;
      }
    }
  }
  // Supervariable members (nv > 1) were already emitted inline via their
  // svnext chains when their representative pivoted, so perm holds each
  // eliminated column once. Fill remaining (isolated) in index order —
  // grouped by constraint class so the class contract survives the safety
  // path too.
  {
    std::vector<int8_t> seen(n, 0);
    int64_t kk = 0;
    std::vector<int64_t> out(n);
    for (int64_t t = 0; t < n && kk < n; ++t) {
      int64_t v = perm[t];
      if (v >= 0 && v < n && !seen[v] && t < k) { seen[v] = 1; out[kk++] = v; }
    }
    std::vector<int64_t> rest;
    for (int64_t v = 0; v < n; ++v)
      if (!seen[v]) rest.push_back(v);
    if (cons)
      std::sort(rest.begin(), rest.end(), [&](int64_t a, int64_t b) {
        return cons[a] != cons[b] ? cons[a] < cons[b] : a < b;
      });
    for (int64_t v : rest)
      if (kk < n) out[kk++] = v;
    std::memcpy(perm, out.data(), n * sizeof(int64_t));
  }
  return 0;
}

int64_t spfx_amd(int64_t n, const int64_t* indptr, const int32_t* indices,
                 int64_t* perm) {
  return amd_impl(n, indptr, indices, nullptr, perm);
}

int64_t spfx_camd(int64_t n, const int64_t* indptr, const int32_t* indices,
                  const int64_t* cons, int64_t* perm) {
  return amd_impl(n, indptr, indices, cons, perm);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host supernodal triangular solves (f64 accumulate over f32 or f64 panels).
//
// The reference's solve is also host-side and sequential
// (SparseFrame_solve_supernodal, Cholesky/Source/SparseFrame.c:3036-3139;
// LU :3592-3700). Panels are row-major with per-supernode stride (see
// spfx/plan/schedule.py); values are the device factor copied back once.
// ---------------------------------------------------------------------------

template <typename T>
static void chol_solve_impl(int64_t nsuper, const int64_t* sn_start,
                            const int64_t* sn_ptr, const int64_t* sn_rows,
                            const int64_t* offsets, const int64_t* strides,
                            const int64_t* bshift, const T* Lv, double* x) {
  // forward: L y = b
  for (int64_t s = 0; s < nsuper; ++s) {
    int64_t c1 = sn_start[s], c2 = sn_start[s + 1];
    int64_t w = c2 - c1, wp = strides[s];
    int64_t p0 = sn_ptr[s], R = sn_ptr[s + 1] - p0;
    const T* P = Lv + offsets[s];
    for (int64_t j = 0; j < w; ++j) {
      double acc = x[c1 + j];
      const T* row = P + j * wp;
      for (int64_t t = 0; t < j; ++t) acc -= (double)row[t] * x[c1 + t];
      x[c1 + j] = acc / (double)row[j];
    }
    int64_t sh = bshift[s];
    for (int64_t r = w; r < R; ++r) {
      const T* row = P + (r + sh) * wp;
      double acc = 0.0;
      for (int64_t t = 0; t < w; ++t) acc += (double)row[t] * x[c1 + t];
      x[sn_rows[p0 + r]] -= acc;
    }
  }
  // backward: L^T x = y
  for (int64_t s = nsuper - 1; s >= 0; --s) {
    int64_t c1 = sn_start[s], c2 = sn_start[s + 1];
    int64_t w = c2 - c1, wp = strides[s];
    int64_t p0 = sn_ptr[s], R = sn_ptr[s + 1] - p0;
    const T* P = Lv + offsets[s];
    int64_t sh = bshift[s];
    for (int64_t j = w - 1; j >= 0; --j) {
      double acc = x[c1 + j];
      for (int64_t r = w; r < R; ++r)
        acc -= (double)P[(r + sh) * wp + j] * x[sn_rows[p0 + r]];
      // (L^T x)_j uses L[t,j] = P[t*wp + j] for t > j (column j of L)
      for (int64_t t = j + 1; t < w; ++t)
        acc -= (double)P[t * wp + j] * x[c1 + t];
      x[c1 + j] = acc / (double)P[j * wp + j];
    }
  }
}

template <typename T>
static void lu_solve_impl(int64_t nsuper, const int64_t* sn_start,
                          const int64_t* sn_ptr, const int64_t* sn_rows,
                          const int64_t* offsets, const int64_t* strides,
                          const int64_t* bshift, const T* Lv, const T* Uv,
                          double* x) {
  // forward: unit-L y = b
  for (int64_t s = 0; s < nsuper; ++s) {
    int64_t c1 = sn_start[s], c2 = sn_start[s + 1];
    int64_t w = c2 - c1, wp = strides[s];
    int64_t p0 = sn_ptr[s], R = sn_ptr[s + 1] - p0;
    const T* P = Lv + offsets[s];
    for (int64_t j = 0; j < w; ++j) {
      double acc = x[c1 + j];
      const T* row = P + j * wp;
      for (int64_t t = 0; t < j; ++t) acc -= (double)row[t] * x[c1 + t];
      x[c1 + j] = acc;                       // unit diagonal
    }
    int64_t sh = bshift[s];
    for (int64_t r = w; r < R; ++r) {
      const T* row = P + (r + sh) * wp;
      double acc = 0.0;
      for (int64_t t = 0; t < w; ++t) acc += (double)row[t] * x[c1 + t];
      x[sn_rows[p0 + r]] -= acc;
    }
  }
  // backward: U x = y. Ux panel stores U^T: Uv[r*wp + c] = U[c1+c, grow(r)]
  for (int64_t s = nsuper - 1; s >= 0; --s) {
    int64_t c1 = sn_start[s], c2 = sn_start[s + 1];
    int64_t w = c2 - c1, wp = strides[s];
    int64_t p0 = sn_ptr[s], R = sn_ptr[s + 1] - p0;
    const T* P = Uv + offsets[s];
    int64_t sh = bshift[s];
    for (int64_t j = w - 1; j >= 0; --j) {
      double acc = x[c1 + j];
      for (int64_t r = w; r < R; ++r)
        acc -= (double)P[(r + sh) * wp + j] * x[sn_rows[p0 + r]];
      for (int64_t t = j + 1; t < w; ++t)
        acc -= (double)P[t * wp + j] * x[c1 + t];   // U[c1+j, c1+t]
      x[c1 + j] = acc / (double)P[j * wp + j];      // pivot U[j,j]
    }
  }
}

extern "C" {

void spfx_chol_solve_f32(int64_t nsuper, const int64_t* sn_start,
                         const int64_t* sn_ptr, const int64_t* sn_rows,
                         const int64_t* offsets, const int64_t* strides,
                         const int64_t* bshift, const float* Lv, double* x) {
  chol_solve_impl<float>(nsuper, sn_start, sn_ptr, sn_rows, offsets, strides,
                       bshift, Lv, x);
}

void spfx_chol_solve_f64(int64_t nsuper, const int64_t* sn_start,
                         const int64_t* sn_ptr, const int64_t* sn_rows,
                         const int64_t* offsets, const int64_t* strides,
                         const int64_t* bshift, const double* Lv, double* x) {
  chol_solve_impl<double>(nsuper, sn_start, sn_ptr, sn_rows, offsets, strides,
                          bshift, Lv, x);
}

void spfx_lu_solve_f32(int64_t nsuper, const int64_t* sn_start,
                       const int64_t* sn_ptr, const int64_t* sn_rows,
                       const int64_t* offsets, const int64_t* strides,
                       const int64_t* bshift, const float* Lv, const float* Uv,
                       double* x) {
  lu_solve_impl<float>(nsuper, sn_start, sn_ptr, sn_rows, offsets, strides,
                     bshift, Lv, Uv, x);
}

void spfx_lu_solve_f64(int64_t nsuper, const int64_t* sn_start,
                       const int64_t* sn_ptr, const int64_t* sn_rows,
                       const int64_t* offsets, const int64_t* strides,
                       const int64_t* bshift, const double* Lv,
                       const double* Uv, double* x) {
  lu_solve_impl<double>(nsuper, sn_start, sn_ptr, sn_rows, offsets, strides,
                        bshift, Lv, Uv, x);
}

}  // extern "C"
