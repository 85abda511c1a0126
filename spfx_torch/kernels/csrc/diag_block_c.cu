// Batched Hermitian Cholesky + explicit inverse of small COMPLEX diagonal
// blocks (potrf_inv_c), for sm_90a, templated on complex64 / complex128.
// Its LU twin getrf_inv_c has a file of its own (getrf_inv_c.cu).
//
// No Pallas kernel computes it: the JAX package routes complex panels
// away from its diagonal-block kernels (potrf_inv_lanes in
// spfx/kernels/pallas_blocks.py takes f32 only) to XLA's expanders
// (spfx/kernels/blocks.py, ``_chol_deltas_blocks``: ``not
// jnp.iscomplexobj``). The port's blocked panel path
// (spfx_torch/kernels/blocks.py) runs every type through one
// diagonal-block contract, so complex blocks get a kernel of their own
// beside the tuned real one (potrf_inv.cu), under the same contract
// (spfx_torch/kernels/panel.py's docstring), task-major (B, nb, nb)
// row-major blocks, nb <= 32, with valid width w = clamp(wrel[b], 0, nb):
// D' = D's lower triangle on rows/cols < w, identity on the padding;
// L = chol(D') with L L^H = D' (real positive pivots: the real part of
// each diagonal entry is taken, and L's diagonal is stored real), zeroed
// on the padding; Linv = L^{-1}, unit rows on the padding. The recurrences
// are those of the plain version (potrf_inv_plain): right-looking
// elimination, then row-serial substitution for the inverse.
//
// What bounds it on the H100: memory, as for the real kernel. Per block of
// live width w it reads w(w+1)/2 complex values and writes 2 nb^2, for
// about 4 x (2/3 w^3) real operations: a few flop per byte, far under the
// card's ridge.
//
// What the design does about it: nothing yet beyond being simple and right.
// One warp per diagonal block, the block and the inverse in shared memory
// (32 x 33 complex values each, 33 against bank conflicts). Lane i holds
// row i during the elimination; lane c holds column c of the inverse
// during the substitution, so the substitution needs no exchange between
// lanes. It divides only by its real pivots. Its critical path is serial
// in nb, as the real one-warp design was before its redesign
// (potrf_inv.cu's notes).

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
int launch_potrf(const void* wrel, const void* D, void* L, void* Linv, int B,
                 int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  if (B > 0)
    potrf_inv_c_kernel<T><<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
        (const int*)wrel, (const Cx<T>*)D, (Cx<T>*)L, (Cx<T>*)Linv, nb);
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
