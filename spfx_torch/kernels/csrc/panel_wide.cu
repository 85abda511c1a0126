// Whole-panel Cholesky and no-pivot LU deltas, task-major ("wide" layout),
// blocked by 32 columns, sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py chol_panel_deltas_wide and
// lu_panel_deltas_wide. Same function as panel_lanes.cu (the deltas
// (new - old) of one PC bucket's panels, width cp <= 256), in the TPU
// kernels' task-major layout:
//   diagonal windows (B, cp, cp), below blocks (B, rbp, cp), row-major.
// Per task b, with w = clamp(widths[b], 0, cp) live columns and
// nb = clamp(nbelow[b], 0, rbp) live below rows:
//   Cholesky: L11 = chol of the live block read from D's lower triangle
//     (the TPU kernel symmetrizes from the lower triangle; a factorization
//     that reads only the lower triangle is the same thing), dd = L11 - D
//     on the live block; L21 = B L11^{-T}, db = L21 - B on the live rows
//     and columns; 0 elsewhere.
//   LU: the front DL on/below the diagonal and DU^T above it; L11 (unit),
//     U11; ddl = L11 - DL, ddu = U11^T - DU; L21 = BL U11^{-1}, U12^T =
//     BU L11^{-T} (unit); dbl, dbu as for Cholesky.
//
// The TPU kernel keeps L11^T (and U11) in scratch from grid step ri == 0
// for the later row-block steps, which only works because a TPU grid runs
// in order. Here each call is TWO launches on the caller's stream: a
// diagonal phase, one thread block per task, which writes the diagonal
// deltas and the factored tile into a workspace the wrapper allocated, and
// a below phase over (task, block of 128 below rows) that reads it. The
// wrapper counts the pair as one launch of the kernel.
//
// What bounds it on the H100: operations, as for the lanes kernels (about
// 173 MFLOP against 5.6 MB in f32 at the path's heaviest Cholesky call,
// cp 256, rbp 2560, B 1; LU twice that). The design follows the TPU
// kernel's blocked right-looking factorization with 32-column panels:
// - a 256 x 256 f64 tile (512 KB) does not fit in the 227 KB of shared
//   memory a block may have, so the tile lives in the workspace and only
//   the current 32-column panel (and for LU the 32-row block of U12) is
//   staged in shared memory (dynamic shared memory, up to 130 KB);
// - inside a panel the unblocked column recurrence runs with one thread per
//   panel row and a barrier per column;
// - the trailing update and the below-panel solve are products over the
//   staged tiles computed in the kernel: one thread per output element for
//   the trailing update; for the below solve one thread per below row keeps
//   32 solution columns in registers, takes the earlier columns'
//   contributions from 32-column tiles of the solution staged in shared
//   memory (coalesced loads), and reads the factor's columns from a staged
//   copy of them.
// Templated on float and double.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCp = 256;        // widest panel the wide family covers
constexpr int kPanel = 32;         // column-panel width of the blocking
constexpr int kLd = kPanel + 1;    // padded row of a staged panel
constexpr int kDiagThreads = 256;  // >= kMaxCp: one thread per panel row
constexpr int kRows = 128;         // below rows (and threads) per block

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <typename T>
constexpr size_t chol_diag_smem() { return (size_t)kMaxCp * kLd * sizeof(T); }
template <typename T>
constexpr size_t lu_diag_smem() {
  return (size_t)kMaxCp * kLd * sizeof(T) + (size_t)kPanel * kMaxCp *
         sizeof(T);
}
template <typename T>
constexpr size_t below_smem() {
  return (size_t)(kMaxCp + kRows) * kLd * sizeof(T);
}

// P (h x pw, row stride kLd) = A[s:s+h, s:s+pw]
template <typename T>
__device__ void stage_panel(T* P, const T* A, int s, int h, int pw, int cp) {
  for (int e = threadIdx.x; e < h * pw; e += blockDim.x) {
    const int i = e / pw, c = e % pw;
    P[i * kLd + c] = A[(long long)(s + i) * cp + s + c];
  }
}

template <typename T>
__device__ void unstage_panel(const T* P, T* A, int s, int h, int pw,
                              int cp) {
  for (int e = threadIdx.x; e < h * pw; e += blockDim.x) {
    const int i = e / pw, c = e % pw;
    A[(long long)(s + i) * cp + s + c] = P[i * kLd + c];
  }
}

// ---------------------------------------------------------------------------
// diagonal phase; workspace A (B, cp, cp) row-major, the tile being factored
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kDiagThreads)
chol_diag_wide(const int* __restrict__ widths, const T* __restrict__ D,
               T* __restrict__ dd, T* __restrict__ W, int cp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int w = clampi(widths[b], cp);
  const long long base = (long long)b * cp * cp;
  const T* Db = D + base;
  T* A = W + base;
  for (int e = tid; e < cp * cp; e += nt) {
    const int i = e / cp, c = e % cp;
    A[e] = (i < w && c <= i) ? Db[e] : T(0);
  }
  __syncthreads();
  for (int s = 0; s < w; s += kPanel) {
    const int pw = min(kPanel, w - s), h = w - s;
    stage_panel(P, A, s, h, pw, cp);
    __syncthreads();
    for (int j = 0; j < pw; ++j) {
      const T piv = T(1) / sqrt(P[j * kLd + j]);
      __syncthreads();                      // all have read the pivot
      for (int i = j + tid; i < h; i += nt) P[i * kLd + j] *= piv;
      __syncthreads();
      for (int i = j + 1 + tid; i < h; i += nt) {
        const T lij = P[i * kLd + j];
        const int cmax = min(i, pw - 1);
        for (int c = j + 1; c <= cmax; ++c)
          P[i * kLd + c] -= lij * P[c * kLd + j];
      }
      __syncthreads();
    }
    unstage_panel(P, A, s, h, pw, cp);
    // trailing update of the lower triangle: A22 -= P2 P2^T
    const int t = h - pw;
    for (int e = tid; e < t * t; e += nt) {
      const int i = e / t, c = e % t;
      if (c > i) continue;
      const T* pi = P + (pw + i) * kLd;
      const T* pc = P + (pw + c) * kLd;
      T acc = T(0);
      for (int k = 0; k < pw; ++k) acc += pi[k] * pc[k];
      A[(long long)(s + pw + i) * cp + s + pw + c] -= acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < cp * cp; e += nt) {
    const int i = e / cp, c = e % cp;
    dd[base + e] = (i < w && c < w) ? (c <= i ? A[e] : T(0)) - Db[e] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kDiagThreads)
lu_diag_wide(const int* __restrict__ widths, const T* __restrict__ DL,
             const T* __restrict__ DU, T* __restrict__ ddl,
             T* __restrict__ ddu, T* __restrict__ W, int cp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);                  // (cp x kLd) panel
  T* R = P + kMaxCp * kLd;                            // (kPanel x cp) U12
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int w = clampi(widths[b], cp);
  const long long base = (long long)b * cp * cp;
  const T* DLb = DL + base;
  const T* DUb = DU + base;
  T* A = W + base;
  for (int e = tid; e < cp * cp; e += nt) {
    const int i = e / cp, c = e % cp;
    A[e] = (i < w && c < w) ? (c <= i ? DLb[e] : DUb[c * cp + i]) : T(0);
  }
  __syncthreads();
  for (int s = 0; s < w; s += kPanel) {
    const int pw = min(kPanel, w - s), h = w - s, t = h - pw;
    stage_panel(P, A, s, h, pw, cp);
    __syncthreads();
    // unblocked no-pivot LU of the h x pw panel (pivot row j is not written
    // in step j, so no barrier is needed before the division)
    for (int j = 0; j < pw; ++j) {
      for (int i = j + 1 + tid; i < h; i += nt) {
        const T l = P[i * kLd + j] / P[j * kLd + j];
        P[i * kLd + j] = l;
        for (int c = j + 1; c < pw; ++c) P[i * kLd + c] -= l * P[j * kLd + c];
      }
      __syncthreads();
    }
    unstage_panel(P, A, s, h, pw, cp);
    // U12 = unit_lower(P[:pw, :pw])^{-1} A[s:s+pw, s+pw:w], one thread per
    // column, the 32 rows in registers
    for (int c = tid; c < t; c += nt) {
      T r[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k)
        r[k] = k < pw ? A[(long long)(s + k) * cp + s + pw + c] : T(0);
#pragma unroll
      for (int k = 1; k < kPanel; ++k) {
        if (k < pw) {
          T v = r[k];
#pragma unroll
          for (int m = 0; m < k; ++m) v -= P[k * kLd + m] * r[m];
          r[k] = v;
        }
      }
#pragma unroll
      for (int k = 0; k < kPanel; ++k)
        if (k < pw) {
          R[k * kMaxCp + c] = r[k];
          A[(long long)(s + k) * cp + s + pw + c] = r[k];
        }
    }
    __syncthreads();
    // trailing update: A22 -= L21 U12
    for (int e = tid; e < t * t; e += nt) {
      const int i = e / t, c = e % t;
      const T* pi = P + (pw + i) * kLd;
      T acc = T(0);
      for (int k = 0; k < pw; ++k) acc += pi[k] * R[k * kMaxCp + c];
      A[(long long)(s + pw + i) * cp + s + pw + c] -= acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < cp * cp; e += nt) {
    const int i = e / cp, c = e % cp;
    const bool live = i < w && c < w;
    ddl[base + e] = live ? (c < i ? A[e] : (c == i ? T(1) : T(0))) - DLb[e]
                         : T(0);
    ddu[base + e] = live ? (c <= i ? A[c * cp + i] : T(0)) - DUb[e] : T(0);
  }
}

// ---------------------------------------------------------------------------
// below phase: block (task b, rows r0 .. r0 + kRows), thread = row
// ---------------------------------------------------------------------------

// X M = Bs[rows, :w], M upper triangular with M(k, j) = A[k*sk + j*sj]
// (unit: no division by its diagonal), for the block's nrows live rows;
// X goes to out. Mp stages M's columns of the current panel, Xs a 32-column
// tile of the block's rows of X.
template <typename T>
__device__ void solve_rows(const T* __restrict__ Bs, T* __restrict__ out,
                           const T* __restrict__ A, int sk, int sj,
                           bool unit, int r0, int nrows, int w, int cp,
                           T* Mp, T* Xs) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool live = tid < nrows;
  const long long row = (long long)(r0 + tid) * cp;
  for (int s = 0; s < w; s += kPanel) {
    const int pw = min(kPanel, w - s);
    __syncthreads();                       // Mp and Xs free again
    for (int e = tid; e < (s + pw) * pw; e += nt) {
      const int k = e / pw, jj = e % pw;
      Mp[k * kLd + jj] = A[(long long)k * sk + (long long)(s + jj) * sj];
    }
    T acc[kPanel];
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj)
      acc[jj] = (live && jj < pw) ? Bs[row + s + jj] : T(0);
    __syncthreads();
    // the earlier panels' contributions, 32 columns of X at a time
    for (int k0 = 0; k0 < s; k0 += kPanel) {
      for (int e = tid; e < nrows * kPanel; e += nt) {
        const int rr = e / kPanel, kk = e % kPanel;
        Xs[rr * kLd + kk] = out[(long long)(r0 + rr) * cp + k0 + kk];
      }
      __syncthreads();
      if (live) {
        for (int kk = 0; kk < kPanel; ++kk) {
          const T xk = Xs[tid * kLd + kk];
          const T* mk = Mp + (k0 + kk) * kLd;
#pragma unroll
          for (int jj = 0; jj < kPanel; ++jj)
            if (jj < pw) acc[jj] -= xk * mk[jj];
        }
      }
      __syncthreads();
    }
    // the panel's own triangle
    if (live) {
#pragma unroll
      for (int jj = 0; jj < kPanel; ++jj) {
        if (jj < pw) {
          const T* mj = Mp + (s + jj) * kLd;
          T x = acc[jj];
          if (!unit) x = x / mj[jj];
          Xs[tid * kLd + jj] = x;
#pragma unroll
          for (int ii = jj + 1; ii < kPanel; ++ii)
            if (ii < pw) acc[ii] -= x * mj[ii];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < nrows * pw; e += nt) {
      const int rr = e / pw, jj = e % pw;
      out[(long long)(r0 + rr) * cp + s + jj] = Xs[rr * kLd + jj];
    }
  }
  __syncthreads();
}

// out = X - Bs on the live rows and columns of the block, 0 elsewhere
template <typename T>
__device__ void finish_rows(const T* __restrict__ Bs, T* __restrict__ out,
                            int r0, int nrows, int rows, int w, int cp) {
  for (int e = threadIdx.x; e < rows * cp; e += blockDim.x) {
    const int rr = e / cp, c = e % cp;
    const long long o = (long long)(r0 + rr) * cp + c;
    out[o] = (rr < nrows && c < w) ? out[o] - Bs[o] : T(0);
  }
}

template <typename T, bool kLU>
__global__ void __launch_bounds__(kRows)
below_wide(const int* __restrict__ widths, const int* __restrict__ nbelow,
           const T* __restrict__ BL, const T* __restrict__ BU,
           T* __restrict__ dbl, T* __restrict__ dbu,
           const T* __restrict__ W, int cp, int rbp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Mp = reinterpret_cast<T*>(smem);                 // (cp x kLd)
  T* Xs = Mp + kMaxCp * kLd;                          // (kRows x kLd)
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int w = clampi(widths[b], cp);
  const int rows = min(kRows, rbp - r0);
  const int nrows = max(0, min(rows, clampi(nbelow[b], rbp) - r0));
  const long long bb = (long long)b * rbp * cp;
  const T* A = W + (long long)b * cp * cp;
  if (kLU) {
    if (nrows > 0) {
      // L21 U11 = BL: M = U11, U(k, j) = A[k*cp + j]
      solve_rows<T>(BL + bb, dbl + bb, A, cp, 1, false, r0, nrows, w, cp,
                    Mp, Xs);
      // U12^T L11^T = BU: M = L11^T, L(j, k) = A[j*cp + k], unit
      solve_rows<T>(BU + bb, dbu + bb, A, 1, cp, true, r0, nrows, w, cp,
                    Mp, Xs);
    }
    finish_rows<T>(BL + bb, dbl + bb, r0, nrows, rows, w, cp);
    finish_rows<T>(BU + bb, dbu + bb, r0, nrows, rows, w, cp);
  } else {
    // L21 L11^T = B: M = L11^T, L(j, k) = A[j*cp + k]
    if (nrows > 0)
      solve_rows<T>(BL + bb, dbl + bb, A, 1, cp, false, r0, nrows, w, cp,
                    Mp, Xs);
    finish_rows<T>(BL + bb, dbl + bb, r0, nrows, rows, w, cp);
  }
}

// Allow a kernel the dynamic shared memory it takes beyond 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

dim3 below_grid(int B, int rbp) {
  return dim3((unsigned)B, (unsigned)((rbp + kRows - 1) / kRows));
}

template <typename T>
int chol_launch(const void* widths, const void* nbelow, const void* D,
                const void* Bm, void* dd, void* db, void* ws, int B, int cp,
                int rbp, void* stream) {
  if (cp < 1 || cp > kMaxCp || B < 0 || rbp < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  static bool smem_allowed = false;   // once, before any graph capture
  cudaError_t e;
  if (!smem_allowed) {
    e = allow_smem(chol_diag_wide<T>, chol_diag_smem<T>());
    if (e == cudaSuccess)
      e = allow_smem(below_wide<T, false>, below_smem<T>());
    if (e != cudaSuccess) return (int)e;
    smem_allowed = true;
  }
  chol_diag_wide<T><<<(unsigned)B, kDiagThreads, chol_diag_smem<T>(), st>>>(
      (const int*)widths, (const T*)D, (T*)dd, (T*)ws, cp);
  e = cudaGetLastError();
  if (e != cudaSuccess || rbp == 0) return (int)e;
  below_wide<T, false><<<below_grid(B, rbp), kRows, below_smem<T>(), st>>>(
      (const int*)widths, (const int*)nbelow, (const T*)Bm, nullptr,
      (T*)db, nullptr, (const T*)ws, cp, rbp);
  return (int)cudaGetLastError();
}

template <typename T>
int lu_launch(const void* widths, const void* nbelow, const void* DL,
              const void* DU, const void* BL, const void* BU, void* ddl,
              void* ddu, void* dbl, void* dbu, void* ws, int B, int cp,
              int rbp, void* stream) {
  if (cp < 1 || cp > kMaxCp || B < 0 || rbp < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  static bool smem_allowed = false;   // once, before any graph capture
  cudaError_t e;
  if (!smem_allowed) {
    e = allow_smem(lu_diag_wide<T>, lu_diag_smem<T>());
    if (e == cudaSuccess)
      e = allow_smem(below_wide<T, true>, below_smem<T>());
    if (e != cudaSuccess) return (int)e;
    smem_allowed = true;
  }
  lu_diag_wide<T><<<(unsigned)B, kDiagThreads, lu_diag_smem<T>(), st>>>(
      (const int*)widths, (const T*)DL, (const T*)DU, (T*)ddl, (T*)ddu,
      (T*)ws, cp);
  e = cudaGetLastError();
  if (e != cudaSuccess || rbp == 0) return (int)e;
  below_wide<T, true><<<below_grid(B, rbp), kRows, below_smem<T>(), st>>>(
      (const int*)widths, (const int*)nbelow, (const T*)BL, (const T*)BU,
      (T*)dbl, (T*)dbu, (const T*)ws, cp, rbp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spfx_chol_panel_wide_f32(const void* widths, const void* nbelow,
                                        const void* D, const void* Bm,
                                        void* dd, void* db, void* ws, int B,
                                        int cp, int rbp, void* stream) {
  return chol_launch<float>(widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp,
                            stream);
}

extern "C" int spfx_chol_panel_wide_f64(const void* widths, const void* nbelow,
                                        const void* D, const void* Bm,
                                        void* dd, void* db, void* ws, int B,
                                        int cp, int rbp, void* stream) {
  return chol_launch<double>(widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp,
                             stream);
}

extern "C" int spfx_lu_panel_wide_f32(const void* widths, const void* nbelow,
                                      const void* DL, const void* DU,
                                      const void* BL, const void* BU,
                                      void* ddl, void* ddu, void* dbl,
                                      void* dbu, void* ws, int B, int cp,
                                      int rbp, void* stream) {
  return lu_launch<float>(widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu,
                          ws, B, cp, rbp, stream);
}

extern "C" int spfx_lu_panel_wide_f64(const void* widths, const void* nbelow,
                                      const void* DL, const void* DU,
                                      const void* BL, const void* BU,
                                      void* ddl, void* ddu, void* dbl,
                                      void* dbu, void* ws, int B, int cp,
                                      int rbp, void* stream) {
  return lu_launch<double>(widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl,
                           dbu, ws, B, cp, rbp, stream);
}
