// Whole-panel Cholesky and no-pivot LU deltas, batch in the last dimension
// ("lanes" layout), sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py chol_panel_deltas_lanes and
// lu_panel_deltas_lanes, in their layout: diagonal windows (cp, cp, B),
// below blocks (rbp, cp, B), the tasks on the last dimension, where the
// TPU kernels put them on the vector lanes. The design (32-column blocks
// over explicit inverses of the diagonal blocks: a diagonal phase, one
// thread block per task, then a phase that tiles the below solves by 32
// rows across the SMs), what bounds it and the device code are in
// panel_blocks.cuh, which panel_wide.cu shares; this file holds the
// layout, the four kernels under their own names and the entry points.

#include "panel_blocks.cuh"

namespace {

// element f = i*cp + c of task b's diagonal window, f = r*cp + c of its
// below block
struct Lanes {
  int B, cp, rbp;
  __device__ __forceinline__ long long diag(long long f, int b) const {
    return f * B + b;
  }
  __device__ __forceinline__ long long below(long long f, int b) const {
    return f * B + b;
  }
};

template <typename T>
__global__ void __launch_bounds__(panel_diag_threads<T>())
chol_diag_lanes(const int* __restrict__ widths, const T* __restrict__ D,
                T* __restrict__ W, Lanes lay, int ldw) {
  chol_diag<T>(widths, D, W, lay, ldw);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
chol_below_lanes(const int* __restrict__ widths,
                 const int* __restrict__ nbelow, const T* __restrict__ D,
                 const T* __restrict__ Bm, T* __restrict__ dd,
                 T* __restrict__ db, const T* __restrict__ W, Lanes lay,
                 int ldw) {
  chol_below<T>(widths, nbelow, D, Bm, dd, db, W, lay, ldw);
}

template <typename T>
__global__ void __launch_bounds__(panel_diag_threads<T>())
lu_diag_lanes(const int* __restrict__ widths, const T* __restrict__ DL,
              const T* __restrict__ DU, T* __restrict__ W, Lanes lay,
              int ldw) {
  lu_diag<T>(widths, DL, DU, W, lay, ldw);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
lu_below_lanes(const int* __restrict__ widths,
               const int* __restrict__ nbelow, const T* __restrict__ DL,
               const T* __restrict__ DU, const T* __restrict__ BL,
               const T* __restrict__ BU, T* __restrict__ ddl,
               T* __restrict__ ddu, T* __restrict__ dbl,
               T* __restrict__ dbu, const T* __restrict__ W, Lanes lay,
               int ldw) {
  lu_below<T>(widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu, W, lay,
              ldw);
}

}  // namespace

extern "C" int spfx_chol_panel_lanes_f32(const void* widths,
                                         const void* nbelow, const void* D,
                                         const void* Bm, void* dd, void* db,
                                         void* ws, int B, int cp, int rbp,
                                         void* stream) {
  return chol_launch<float, Lanes>(
      chol_diag_lanes<float>, chol_below_lanes<float>,
      widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp, stream);
}

extern "C" int spfx_chol_panel_lanes_f64(const void* widths,
                                         const void* nbelow, const void* D,
                                         const void* Bm, void* dd, void* db,
                                         void* ws, int B, int cp, int rbp,
                                         void* stream) {
  return chol_launch<double, Lanes>(
      chol_diag_lanes<double>, chol_below_lanes<double>,
      widths, nbelow, D, Bm, dd, db, ws, B, cp, rbp, stream);
}

extern "C" int spfx_lu_panel_lanes_f32(const void* widths, const void* nbelow,
                                       const void* DL, const void* DU,
                                       const void* BL, const void* BU,
                                       void* ddl, void* ddu, void* dbl,
                                       void* dbu, void* ws, int B, int cp,
                                       int rbp, void* stream) {
  return lu_launch<float, Lanes>(
      lu_diag_lanes<float>, lu_below_lanes<float>,
      widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu, ws, B, cp, rbp,
      stream);
}

extern "C" int spfx_lu_panel_lanes_f64(const void* widths, const void* nbelow,
                                       const void* DL, const void* DU,
                                       const void* BL, const void* BU,
                                       void* ddl, void* ddu, void* dbl,
                                       void* dbu, void* ws, int B, int cp,
                                       int rbp, void* stream) {
  return lu_launch<double, Lanes>(
      lu_diag_lanes<double>, lu_below_lanes<double>,
      widths, nbelow, DL, DU, BL, BU, ddl, ddu, dbl, dbu, ws, B, cp, rbp,
      stream);
}
