// Whole-panel Cholesky and no-pivot LU deltas, batch in the last dimension
// ("lanes" layout), sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py chol_panel_deltas_lanes and
// lu_panel_deltas_lanes: one call factors every panel of one PC bucket,
// panel width cp <= 256, and returns the deltas (new - old) that the
// router in spfx_torch/kernels/blocks.py adds onto the panels. The layout
// is the TPU kernels' own, which put the tasks on the vector lanes:
//   diagonal windows  (cp, cp, B): element (i, c) of task b at (i*cp + c)*B + b
//   below blocks     (rbp, cp, B): element (r, c) of task b at (r*cp + c)*B + b
//
// What it computes, per task b with w = clamp(widths[b], 0, cp) live
// columns and nb = clamp(nbelow[b], 0, rbp) live below rows:
//   Cholesky: L11 = chol of D's lower triangle on the live block (the upper
//     triangle is never read); dd = L11 - D on the live block, 0 elsewhere
//     (so dd = -D above the diagonal); L21 = B L11^{-T} on the live
//     columns; db = L21 - B on the live rows and columns, 0 elsewhere.
//   LU: the front D = DL on and below the diagonal, DU^T above it (live
//     block); its no-pivot LU, L11 unit lower, U11 upper; ddl = L11 - DL,
//     ddu = U11^T - DU on the live block; L21 = BL U11^{-1}, U12^T =
//     BU L11^{-T} (unit); dbl = L21 - BL, dbu = U12^T - BU on the live rows
//     and columns. The TPU kernel pads the front with the identity; the
//     padding never meets the live block, so this one skips it.
//
// The TPU kernel factors L11 (and U11) at grid step ri == 0 and keeps it in
// scratch for the later row-block steps: a TPU grid runs in order. Thread
// blocks on the card run in no order, so each call is TWO launches on the
// caller's stream: a diagonal phase (one thread block per task) that writes
// the diagonal deltas and the factor into a workspace the wrapper allocated,
// then a below phase (one thread per task and below row) that reads it.
// The wrapper counts the pair as one launch of the kernel.
//
// What bounds it on the H100: at the path's heaviest call (cp 256, rbp
// 2560, B 1) about 173 MFLOP against 5.6 MB in f32 (2.5 us at 67 TFLOP/s),
// so operations; nearly all of them are the below solve (rbp w^2), not the
// w^3/3 of the factorization. What stands between the kernel and that
// bound is dependence, not bytes:
// - diagonal phase: w dependent column steps with a block-wide barrier
//   each; thread i owns row i (threads over rows, as the TPU kernel puts
//   rows on sublanes), the working matrix sits column-major in the
//   workspace so that a step's reads and writes are coalesced across the
//   threads, and column j (Cholesky) or row k of U (LU) is broadcast
//   through shared memory;
// - below phase: every below row solves independently against the shared
//   factor, so there are rbp*B threads; each keeps 32 columns of its
//   solution in registers (fully unrolled), subtracts the earlier columns'
//   contributions 32 at a time, then solves the 32-column diagonal block.
//   Consecutive threads are consecutive tasks, so for B >= 32 a warp reads
//   neighbouring addresses; for small B the threads of a warp share one
//   task and the factor's loads are broadcasts.
// Templated on float and double.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCp = 256;       // widest panel the lanes family covers
constexpr int kPanel = 32;        // columns held in registers by a row solve
constexpr int kBelowThreads = 128;

__device__ __forceinline__ long long lidx(int i, int c, int b, int cp,
                                          int B) {
  return ((long long)i * cp + c) * B + b;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// diagonal phase; workspace W (B, cp, cp): W[b][c*cp + i] holds A[i][c]
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxCp)
chol_diag_lanes(const int* __restrict__ widths, const T* __restrict__ D,
                T* __restrict__ dd, T* __restrict__ W, int B, int cp) {
  __shared__ T col[kMaxCp];
  const int b = blockIdx.x;
  const int i = threadIdx.x;                      // row i
  const int w = clampi(widths[b], cp);
  T* Wb = W + (long long)b * cp * cp;
  if (i < cp)
    for (int c = 0; c < cp; ++c)
      Wb[c * cp + i] = (i < w && c <= i) ? D[lidx(i, c, b, cp, B)] : T(0);
  __syncthreads();
  // right-looking column recurrence (_potrf_lanes): scale column j by
  // 1/sqrt(pivot), then the rank-1 update of the lower trailing part
  for (int j = 0; j < w; ++j) {
    if (i >= j && i < w)
      col[i] = Wb[j * cp + i] * (T(1) / sqrt(Wb[j * cp + j]));
    __syncthreads();
    if (i >= j && i < w) {
      const T li = col[i];
      Wb[j * cp + i] = li;
      for (int c = j + 1; c <= i; ++c) Wb[c * cp + i] -= li * col[c];
    }
    __syncthreads();
  }
  if (i < cp)
    for (int c = 0; c < cp; ++c) {
      const long long o = lidx(i, c, b, cp, B);
      dd[o] = (i < w && c < w) ? (c <= i ? Wb[c * cp + i] : T(0)) - D[o]
                               : T(0);
    }
}

template <typename T>
__global__ void __launch_bounds__(kMaxCp)
lu_diag_lanes(const int* __restrict__ widths, const T* __restrict__ DL,
              const T* __restrict__ DU, T* __restrict__ ddl,
              T* __restrict__ ddu, T* __restrict__ W, int B, int cp) {
  __shared__ T urow[kMaxCp];
  const int b = blockIdx.x;
  const int i = threadIdx.x;                      // row i
  const int w = clampi(widths[b], cp);
  T* Wb = W + (long long)b * cp * cp;
  // the front: DL on and below the diagonal, DU^T above it
  if (i < cp)
    for (int c = 0; c < cp; ++c)
      Wb[c * cp + i] = (i < w && c < w)
                           ? (c <= i ? DL[lidx(i, c, b, cp, B)]
                                     : DU[lidx(c, i, b, cp, B)])
                           : T(0);
  __syncthreads();
  // right-looking no-pivot elimination (_getrf_lanes): row k of U goes to
  // shared memory, rows below divide column k by the pivot and take the
  // rank-1 update
  for (int k = 0; k < w; ++k) {
    for (int j = k + i; j < w; j += blockDim.x) urow[j] = Wb[j * cp + k];
    __syncthreads();
    if (i > k && i < w) {
      const T l = Wb[k * cp + i] / urow[k];
      Wb[k * cp + i] = l;
      for (int j = k + 1; j < w; ++j) Wb[j * cp + i] -= l * urow[j];
    }
    __syncthreads();
  }
  if (i < cp)
    for (int c = 0; c < cp; ++c) {
      const long long o = lidx(i, c, b, cp, B);
      const bool live = i < w && c < w;
      ddl[o] = live ? (c < i ? Wb[c * cp + i] : (c == i ? T(1) : T(0)))
                          - DL[o]
                    : T(0);
      ddu[o] = live ? (c <= i ? Wb[i * cp + c] : T(0)) - DU[o] : T(0);
    }
}

// ---------------------------------------------------------------------------
// below phase
// ---------------------------------------------------------------------------

// x M = Bs[r, :w] for one below row r of task b, M upper triangular with
// M(k, j) = Wb[k*sk + j*sj] (unit: no division by its diagonal); x goes to
// out[r, :w].
template <typename T>
__device__ void solve_row(const T* __restrict__ Bs, T* __restrict__ out,
                          const T* __restrict__ Wb, int sk, int sj,
                          bool unit, int r, int b, int w, int cp, int B) {
  for (int s = 0; s < w; s += kPanel) {
    const int pw = min(kPanel, w - s);
    T acc[kPanel];
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj)
      acc[jj] = jj < pw ? Bs[lidx(r, s + jj, b, cp, B)] : T(0);
    for (int k = 0; k < s; ++k) {
      const T xk = out[lidx(r, k, b, cp, B)];
      const T* mk = Wb + (long long)k * sk + (long long)s * sj;
#pragma unroll
      for (int jj = 0; jj < kPanel; ++jj)
        if (jj < pw) acc[jj] -= xk * mk[jj * sj];
    }
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj) {
      if (jj < pw) {
        const T* mj = Wb + (long long)(s + jj) * sk + (long long)s * sj;
        T x = acc[jj];
        if (!unit) x = x / mj[jj * sj];
        out[lidx(r, s + jj, b, cp, B)] = x;
#pragma unroll
        for (int ii = jj + 1; ii < kPanel; ++ii)
          if (ii < pw) acc[ii] -= x * mj[ii * sj];
      }
    }
  }
}

// out[r, :] = x - Bs on the live columns of a live row, 0 elsewhere
template <typename T>
__device__ void finish_row(const T* __restrict__ Bs, T* __restrict__ out,
                           bool live_row, int r, int b, int w, int cp,
                           int B) {
  for (int c = 0; c < cp; ++c) {
    const long long o = lidx(r, c, b, cp, B);
    out[o] = (live_row && c < w) ? out[o] - Bs[o] : T(0);
  }
}

template <typename T, bool kLU>
__global__ void __launch_bounds__(kBelowThreads)
below_lanes(const int* __restrict__ widths, const int* __restrict__ nbelow,
            const T* __restrict__ BL, const T* __restrict__ BU,
            T* __restrict__ dbl, T* __restrict__ dbu,
            const T* __restrict__ W, int B, int cp, int rbp) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rbp * B) return;
  const int b = (int)(t % B);
  const int r = (int)(t / B);
  const int w = clampi(widths[b], cp);
  const bool live = r < clampi(nbelow[b], rbp);
  const T* Wb = W + (long long)b * cp * cp;
  if (kLU) {
    // L21 U11 = BL: M = U11, U(k, j) = A[k][j] = Wb[j*cp + k]
    // U12^T L11^T = BU: M = L11^T, L(j, k) = A[j][k] = Wb[k*cp + j], unit
    if (live) {
      solve_row<T>(BL, dbl, Wb, 1, cp, false, r, b, w, cp, B);
      solve_row<T>(BU, dbu, Wb, cp, 1, true, r, b, w, cp, B);
    }
    finish_row<T>(BL, dbl, live, r, b, w, cp, B);
    finish_row<T>(BU, dbu, live, r, b, w, cp, B);
  } else {
    // L21 L11^T = B: M = L11^T, L(j, k) = Wb[k*cp + j]
    if (live) solve_row<T>(BL, dbl, Wb, cp, 1, false, r, b, w, cp, B);
    finish_row<T>(BL, dbl, live, r, b, w, cp, B);
  }
}

int diag_threads(int cp) { return (cp + 31) / 32 * 32; }

unsigned below_blocks(int B, int rbp) {
  return (unsigned)(((long long)B * rbp + kBelowThreads - 1) /
                    kBelowThreads);
}

template <typename T>
int chol_launch(const void* widths, const void* nbelow, const void* D,
                const void* Bm, void* dd, void* db, void* ws, int B, int cp,
                int rbp, void* stream) {
  if (cp < 1 || cp > kMaxCp || B < 0 || rbp < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  chol_diag_lanes<T><<<(unsigned)B, diag_threads(cp), 0, st>>>(
      (const int*)widths, (const T*)D, (T*)dd, (T*)ws, B, cp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || rbp == 0) return (int)e;
  below_lanes<T, false><<<below_blocks(B, rbp), kBelowThreads, 0, st>>>(
      (const int*)widths, (const int*)nbelow, (const T*)Bm, nullptr,
      (T*)db, nullptr, (const T*)ws, B, cp, rbp);
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
  lu_diag_lanes<T><<<(unsigned)B, diag_threads(cp), 0, st>>>(
      (const int*)widths, (const T*)DL, (const T*)DU, (T*)ddl, (T*)ddu,
      (T*)ws, B, cp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || rbp == 0) return (int)e;
  below_lanes<T, true><<<below_blocks(B, rbp), kBelowThreads, 0, st>>>(
      (const int*)widths, (const int*)nbelow, (const T*)BL, (const T*)BU,
      (T*)dbl, (T*)dbu, (const T*)ws, B, cp, rbp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spfx_chol_panel_lanes_f32(const void* widths,
                                         const void* nbelow, const void* D,
                                         const void* Bm, void* dd, void* db,
                                         void* ws, int B, int cp, int rbp,
                                         void* stream) {
  return chol_launch<float>(widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp,
                            stream);
}

extern "C" int spfx_chol_panel_lanes_f64(const void* widths,
                                         const void* nbelow, const void* D,
                                         const void* Bm, void* dd, void* db,
                                         void* ws, int B, int cp, int rbp,
                                         void* stream) {
  return chol_launch<double>(widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp,
                             stream);
}

extern "C" int spfx_lu_panel_lanes_f32(const void* widths, const void* nbelow,
                                       const void* DL, const void* DU,
                                       const void* BL, const void* BU,
                                       void* ddl, void* ddu, void* dbl,
                                       void* dbu, void* ws, int B, int cp,
                                       int rbp, void* stream) {
  return lu_launch<float>(widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu,
                          ws, B, cp, rbp, stream);
}

extern "C" int spfx_lu_panel_lanes_f64(const void* widths, const void* nbelow,
                                       const void* DL, const void* DU,
                                       const void* BL, const void* BU,
                                       void* ddl, void* ddu, void* dbl,
                                       void* dbu, void* ws, int B, int cp,
                                       int rbp, void* stream) {
  return lu_launch<double>(widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl,
                           dbu, ws, B, cp, rbp, stream);
}
