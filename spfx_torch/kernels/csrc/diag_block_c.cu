// Batched factorizations + explicit inverses of small COMPLEX diagonal
// blocks, for sm_90a: potrf_inv_c (Hermitian Cholesky) and getrf_inv_c
// (no-pivot LU), templated on complex64 / complex128.
//
// No Pallas kernel computes these: the JAX package routes complex panels
// away from its diagonal-block kernels (potrf_inv_lanes, getrf_inv_lanes
// in spfx/kernels/pallas_blocks.py take f32 only) to XLA's expanders
// (spfx/kernels/blocks.py, ``_chol_deltas_blocks`` and
// ``_lu_deltas_blocks``: ``not jnp.iscomplexobj``). The port's blocked
// panel path (spfx_torch/kernels/blocks.py) runs every type through one
// diagonal-block contract, so complex blocks get kernels of their own
// beside the tuned real ones (potrf_inv.cu, getrf_inv.cu), under the same
// contract (spfx_torch/kernels/panel.py's docstring), task-major (B, nb,
// nb) row-major blocks, nb <= 32, with valid width w = clamp(wrel[b], 0,
// nb):
//   potrf_inv_c: D' = D's lower triangle on rows/cols < w, identity on the
//     padding; L = chol(D') with L L^H = D' (real positive pivots: the
//     real part of each diagonal entry is taken, and L's diagonal is
//     stored real), zeroed on the padding; Linv = L^{-1}, unit rows on the
//     padding.
//   getrf_inv_c: D' = D on rows/cols < w (both triangles), identity on the
//     padding; unit-lower L and upper U of D' = L U (no pivoting, complex
//     division), both zeroed on the padding; Linv and Uinv the inverses of
//     the unmasked factors, the identity on the padding.
// The recurrences are those of the plain versions (potrf_inv_plain,
// getrf_inv_plain): right-looking elimination, then row-serial
// substitution for the inverses (Uinv as the transpose of (U^T)^{-1}).
//
// What bounds it on the H100: memory, as for the real kernels. Per block of
// live width w it reads w(w+1)/2 (potrf) or w^2 (getrf) complex values and
// writes 2 nb^2 (potrf) or 4 nb^2 (getrf), for about 4 x (2/3 w^3) real
// operations: a few flop per byte, far under the card's ridge.
//
// What the design does about it: nothing yet beyond being simple and right.
// One warp per diagonal block, the block and the inverse in shared memory
// (32 x 33 complex values each, 33 against bank conflicts). Lane i holds
// row i during the elimination; lane c holds column c of an inverse during
// the substitution, so the substitution needs no exchange between lanes.
// Every division is Smith's scaled complex division (Cholesky divides only
// by its real pivots). Its critical path is serial in nb, as the real
// one-warp design was before its redesign (potrf_inv.cu's notes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNB = 32;

template <typename T>
struct Cx {
  T re, im;
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// a * conj(b)
template <typename T>
__device__ __forceinline__ Cx<T> cmulc(Cx<T> a, Cx<T> b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}

template <typename T>
__device__ __forceinline__ Cx<T> csub(Cx<T> a, Cx<T> b) {
  return {a.re - b.re, a.im - b.im};
}

template <typename T>
__device__ __forceinline__ Cx<T> cscale(Cx<T> a, T s) {
  return {a.re * s, a.im * s};
}

// a / b, Smith's algorithm: no intermediate |b|^2 to overflow
template <typename T>
__device__ __forceinline__ Cx<T> cdiv(Cx<T> a, Cx<T> b) {
  if (fabs(b.re) >= fabs(b.im)) {
    const T r = b.im / b.re;
    const T d = b.re + b.im * r;
    return {(a.re + a.im * r) / d, (a.im - a.re * r) / d};
  }
  const T r = b.re / b.im;
  const T d = b.re * r + b.im;
  return {(a.re * r + a.im) / d, (a.im * r - a.re) / d};
}

template <typename T>
__device__ __forceinline__ Cx<T> unit(bool one) {
  return {one ? T(1) : T(0), T(0)};
}

template <typename T>
__global__ void potrf_inv_c_kernel(const int* __restrict__ wrel,
                                   const Cx<T>* __restrict__ D,
                                   Cx<T>* __restrict__ Lout,
                                   Cx<T>* __restrict__ Linv, int nb) {
  __shared__ Cx<T> A[kNB][kNB + 1];
  __shared__ Cx<T> X[kNB][kNB + 1];
  const int lane = threadIdx.x;
  const int w = min(max(wrel[blockIdx.x], 0), nb);
  const long long base = (long long)blockIdx.x * nb * nb;
  if (lane < nb) {
    for (int i = 0; i < nb; ++i) {
      Cx<T> v = unit<T>(i == lane);
      if (i < w && lane < w) v = lane <= i ? D[base + (long long)i * nb + lane]
                                           : unit<T>(false);
      A[i][lane] = v;
    }
  }
  __syncwarp();
  // column Cholesky, lane i on row i: column j scaled by its real pivot,
  // then A[i][k] -= L[i][j] conj(L[k][j]) on the trailing lower triangle
  for (int j = 0; j < nb; ++j) {
    const T p = rsqrt_(A[j][j].re);
    __syncwarp();
    if (lane >= j && lane < nb) {
      Cx<T> v = cscale(A[lane][j], p);
      if (lane == j) v.im = T(0);
      A[lane][j] = v;
    }
    __syncwarp();
    if (lane > j && lane < nb) {
      const Cx<T> lij = A[lane][j];
      for (int k = j + 1; k <= lane; ++k)
        A[lane][k] = csub(A[lane][k], cmulc(lij, A[k][j]));
    }
    __syncwarp();
  }
  // Linv, lane c on column c: X[i][c] = (delta_ic - sum_{c<=k<i} L[i][k]
  // X[k][c]) / L[i][i]
  if (lane < nb) {
    for (int i = 0; i < nb; ++i) {
      Cx<T> acc = unit<T>(i == lane);
      for (int k = lane; k < i; ++k) acc = csub(acc, cmul(A[i][k], X[k][lane]));
      X[i][lane] = i < lane ? unit<T>(false) : cscale(acc, T(1) / A[i][i].re);
    }
    for (int i = 0; i < nb; ++i) {
      const long long o = base + (long long)i * nb + lane;
      const bool live = i < w && lane < w && lane <= i;
      Lout[o] = live ? A[i][lane] : unit<T>(false);
      Linv[o] = X[i][lane];
    }
  }
}

template <typename T>
__global__ void getrf_inv_c_kernel(const int* __restrict__ wrel,
                                   const Cx<T>* __restrict__ D,
                                   Cx<T>* __restrict__ Lout,
                                   Cx<T>* __restrict__ Uout,
                                   Cx<T>* __restrict__ Linv,
                                   Cx<T>* __restrict__ Uinv, int nb) {
  __shared__ Cx<T> A[kNB][kNB + 1];
  __shared__ Cx<T> X[kNB][kNB + 1];
  const int lane = threadIdx.x;
  const int w = min(max(wrel[blockIdx.x], 0), nb);
  const long long base = (long long)blockIdx.x * nb * nb;
  if (lane < nb) {
    for (int i = 0; i < nb; ++i)
      A[i][lane] = (i < w && lane < w) ? D[base + (long long)i * nb + lane]
                                       : unit<T>(i == lane);
  }
  __syncwarp();
  // right-looking no-pivot LU, lane i on row i: L[i][k] = A[i][k] / A[k][k],
  // then row i's trailing part takes -L[i][k] A[k][:]
  for (int k = 0; k < nb - 1; ++k) {
    if (lane > k && lane < nb) {
      const Cx<T> l = cdiv(A[lane][k], A[k][k]);
      for (int c = k + 1; c < nb; ++c)
        A[lane][c] = csub(A[lane][c], cmul(l, A[k][c]));
      A[lane][k] = l;
    }
    __syncwarp();
  }
  if (lane < nb) {
    // L and U, masked to the live block
    for (int i = 0; i < nb; ++i) {
      const long long o = base + (long long)i * nb + lane;
      const bool live = i < w && lane < w;
      const Cx<T> a = A[i][lane];
      Lout[o] = !live ? unit<T>(false)
                      : (lane < i ? a : unit<T>(lane == i));
      Uout[o] = (live && lane >= i) ? a : unit<T>(false);
    }
    // Linv (unit L), lane c on column c
    for (int i = 0; i < nb; ++i) {
      Cx<T> acc = unit<T>(i == lane);
      for (int k = lane; k < i; ++k) acc = csub(acc, cmul(A[i][k], X[k][lane]));
      X[i][lane] = i < lane ? unit<T>(false) : acc;
    }
    for (int i = 0; i < nb; ++i)
      Linv[base + (long long)i * nb + lane] = X[i][lane];
  }
  __syncwarp();
  if (lane < nb) {
    // Y = (U^T)^{-1}, lane c on column c: Y[i][c] = (delta_ic - sum_{c<=k<i}
    // U[k][i] Y[k][c]) / U[i][i]; Uinv = Y^T
    for (int i = 0; i < nb; ++i) {
      Cx<T> acc = unit<T>(i == lane);
      for (int k = lane; k < i; ++k) acc = csub(acc, cmul(A[k][i], X[k][lane]));
      X[i][lane] = i < lane ? unit<T>(false) : cdiv(acc, A[i][i]);
    }
  }
  __syncwarp();
  if (lane < nb) {
    for (int i = 0; i < nb; ++i)
      Uinv[base + (long long)i * nb + lane] = X[lane][i];
  }
}

template <typename T>
int launch_potrf(const void* wrel, const void* D, void* L, void* Linv, int B,
                 int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  if (B > 0)
    potrf_inv_c_kernel<T><<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
        (const int*)wrel, (const Cx<T>*)D, (Cx<T>*)L, (Cx<T>*)Linv, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_getrf(const void* wrel, const void* D, void* L, void* U,
                 void* Linv, void* Uinv, int B, int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  if (B > 0)
    getrf_inv_c_kernel<T><<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
        (const int*)wrel, (const Cx<T>*)D, (Cx<T>*)L, (Cx<T>*)U,
        (Cx<T>*)Linv, (Cx<T>*)Uinv, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spfx_potrf_inv_c64(const void* wrel, const void* D, void* L,
                                  void* Linv, int B, int nb, void* stream) {
  return launch_potrf<float>(wrel, D, L, Linv, B, nb, stream);
}

extern "C" int spfx_potrf_inv_c128(const void* wrel, const void* D, void* L,
                                   void* Linv, int B, int nb, void* stream) {
  return launch_potrf<double>(wrel, D, L, Linv, B, nb, stream);
}

extern "C" int spfx_getrf_inv_c64(const void* wrel, const void* D, void* L,
                                  void* U, void* Linv, void* Uinv, int B,
                                  int nb, void* stream) {
  return launch_getrf<float>(wrel, D, L, U, Linv, Uinv, B, nb, stream);
}

extern "C" int spfx_getrf_inv_c128(const void* wrel, const void* D, void* L,
                                   void* U, void* Linv, void* Uinv, int B,
                                   int nb, void* stream) {
  return launch_getrf<double>(wrel, D, L, U, Linv, Uinv, B, nb, stream);
}
