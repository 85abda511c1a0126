// Whole-panel Cholesky and no-pivot LU deltas, task-major ("wide" layout),
// sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py chol_panel_deltas_wide and
// lu_panel_deltas_wide, in their layout: diagonal windows (B, cp, cp),
// below blocks (B, rbp, cp), row-major. The design is the lanes kernels'
// (panel_blocks.cuh, shared with panel_lanes.cu): 32-column blocks over
// explicit inverses of the 32 x 32 diagonal blocks, in two launches on the
// caller's stream (the pair counts as one launch of the kernel):
// - chol_diag_wide / lu_diag_wide, one thread block per task (512 threads
//   in f32, 256 in f64): right-looking, one block ahead, one warp (two for
//   LU) factoring and inverting the next diagonal block in registers while
//   the others update the trailing matrix in 4 x 4 register tiles; the
//   factor and the inverses go to a workspace (B, cp + 32, ldw) for
//   Cholesky, (B, cp + 64, ldw) for LU, ldw = cp rounded up to 32;
// - chol_below_wide / lu_below_wide, grid (B, ceil(rbp/32) + ceil(cp/32))
//   for Cholesky and twice that for LU's two solves, 128 threads: each
//   thread block solves 32 below rows in shared memory against the factor
//   in the workspace, or writes 32 rows of the diagonal deltas.
// The one difference from lanes is where the caller's values lie: a row
// of a task-major block is contiguous, so every copy of a diagonal window
// or a below block reads and writes whole rows, where the lanes layout
// puts each value of a row in its own 32-byte sector once B >= 8. At
// B = 1 the two layouts are the same bytes. Copies of the below blocks
// four values at a time (where cp % 4 == 0 and the rows are 16-byte
// aligned) were measured and are not used: they took 6-10% longer at the
// 48^3 plan's calls with the most tasks, and the same at B = 1.

#include "panel_blocks.cuh"

namespace {

// element f = i*cp + c of task b's diagonal window, f = r*cp + c of its
// below block
struct TaskMajor {
  int B, cp, rbp;
  __device__ __forceinline__ long long diag(long long f, int b) const {
    return (long long)b * cp * cp + f;
  }
  __device__ __forceinline__ long long below(long long f, int b) const {
    return (long long)b * rbp * cp + f;
  }
};

template <typename T>
__global__ void __launch_bounds__(panel_diag_threads<T>())
chol_diag_wide(const int* __restrict__ widths, const T* __restrict__ D,
               T* __restrict__ W, TaskMajor lay, int ldw) {
  chol_diag<T>(widths, D, W, lay, ldw);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
chol_below_wide(const int* __restrict__ widths,
                const int* __restrict__ nbelow, const T* __restrict__ D,
                const T* __restrict__ Bm, T* __restrict__ dd,
                T* __restrict__ db, const T* __restrict__ W, TaskMajor lay,
                int ldw) {
  chol_below<T>(widths, nbelow, D, Bm, dd, db, W, lay, ldw);
}

template <typename T>
__global__ void __launch_bounds__(panel_diag_threads<T>())
lu_diag_wide(const int* __restrict__ widths, const T* __restrict__ DL,
             const T* __restrict__ DU, T* __restrict__ W, TaskMajor lay,
             int ldw) {
  lu_diag<T>(widths, DL, DU, W, lay, ldw);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
lu_below_wide(const int* __restrict__ widths,
              const int* __restrict__ nbelow, const T* __restrict__ DL,
              const T* __restrict__ DU, const T* __restrict__ BL,
              const T* __restrict__ BU, T* __restrict__ ddl,
              T* __restrict__ ddu, T* __restrict__ dbl,
              T* __restrict__ dbu, const T* __restrict__ W, TaskMajor lay,
              int ldw) {
  lu_below<T>(widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu, W, lay,
              ldw);
}

}  // namespace

extern "C" int spfx_chol_panel_wide_f32(const void* widths, const void* nbelow,
                                        const void* D, const void* Bm,
                                        void* dd, void* db, void* ws, int B,
                                        int cp, int rbp, void* stream) {
  return chol_launch<float, TaskMajor>(
      chol_diag_wide<float>, chol_below_wide<float>,
      widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp, stream);
}

extern "C" int spfx_chol_panel_wide_f64(const void* widths, const void* nbelow,
                                        const void* D, const void* Bm,
                                        void* dd, void* db, void* ws, int B,
                                        int cp, int rbp, void* stream) {
  return chol_launch<double, TaskMajor>(
      chol_diag_wide<double>, chol_below_wide<double>,
      widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp, stream);
}

extern "C" int spfx_lu_panel_wide_f32(const void* widths, const void* nbelow,
                                      const void* DL, const void* DU,
                                      const void* BL, const void* BU,
                                      void* ddl, void* ddu, void* dbl,
                                      void* dbu, void* ws, int B, int cp,
                                      int rbp, void* stream) {
  return lu_launch<float, TaskMajor>(
      lu_diag_wide<float>, lu_below_wide<float>,
      widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu, ws, B, cp, rbp,
      stream);
}

extern "C" int spfx_lu_panel_wide_f64(const void* widths, const void* nbelow,
                                      const void* DL, const void* DU,
                                      const void* BL, const void* BU,
                                      void* ddl, void* ddu, void* dbl,
                                      void* dbu, void* ws, int B, int cp,
                                      int rbp, void* stream) {
  return lu_launch<double, TaskMajor>(
      lu_diag_wide<double>, lu_below_wide<double>,
      widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu, ws, B, cp, rbp,
      stream);
}
