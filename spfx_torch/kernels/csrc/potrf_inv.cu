// Batched Cholesky + explicit inverse of small diagonal blocks, for sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py potrf_inv_lanes: the serial part
// of the blocked panel factorization (spfx_torch/kernels/blocks.py
// _chol_deltas_blocked), once per NB = 32 column block of a panel bucket.
// The TPU kernel keeps the batch in the vector lanes, (nb, nb, B); this one
// is task-major, (B, nb, nb), row-major blocks, nb <= 32.
//
// What it computes, per block b with valid width w = clamp(wrel[b], 0, nb):
//   D'  = D masked to its lower triangle on rows/cols < w, identity on the
//         padding (only D's lower triangle is read: the upper triangle of a
//         panel's diagonal window holds trailing-update junk);
//   L    = chol(D'), zeroed on the padding rows and columns (w = 0: L = 0);
//   Linv = chol(D')^{-1}, whose padding rows are unit rows (w = 0: I).
// The column recurrence is the TPU kernel's: column j is scaled by
// rsqrt(d_jj) (the diagonal included), then the trailing lower triangle
// takes the rank-1 update; the inverse is the row-serial forward
// substitution X[i, :] = (e_i - L[i, :i] X[:i, :]) / L[i, i].
// A block with nb < 32 is treated as the leading part of a 32-wide block
// whose padding is the identity, which changes nothing on the first nb.
//
// What bounds it on the H100: memory. Per block of live width w it reads
// the w(w+1)/2 values of D's live lower triangle and writes 2*nb*nb values
// for ~2/3 w^3 operations (about 2 flop per byte in f32 at w = nb), far
// under the card's ridge, so the floor is those bytes over 3.35 TB/s.
// What stands between the kernel and that floor is the serial
// dependence along the columns: 2*nb dependent steps per block, each a
// latency, not a throughput, cost.
//
// What the design does about it: one warp per block and one block per
// thread block, so B blocks spread over all SMs. The block moves between
// device memory and a (32 x 33) shared-memory tile with coalesced row
// loads and stores (lane c on column c; the padded row keeps the transpose
// free of bank conflicts). In between, everything lives in registers: lane
// i holds row i of the block during the factorization and column i of the
// inverse during the substitution, both loops fully unrolled, and the one
// value a step needs from another row arrives by warp shuffle. A step thus
// costs a shuffle and a fused multiply-add, with no shared-memory round
// trip and no barrier. Templated on float and double.

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 32;   // the blocked panel path's diagonal block size
constexpr int kLd = kNB + 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__global__ void __launch_bounds__(32)
potrf_inv_kernel(const int* __restrict__ wrel, const T* __restrict__ D,
                 T* __restrict__ Lout, T* __restrict__ Linv, int nb) {
  __shared__ T S[kNB][kLd];
  const int lane = threadIdx.x;
  const long long base = (long long)blockIdx.x * nb * nb;
  int w = wrel[blockIdx.x];
  w = w < 0 ? 0 : (w > nb ? nb : w);

  // stage: the lower triangle of the live block, identity on the padding
  for (int r = 0; r < kNB; ++r) {
    T v = T(0);
    if (r < w && lane <= r)
      v = D[base + (long long)r * nb + lane];
    else if (r == lane && r >= w)
      v = T(1);
    S[r][lane] = v;
  }
  __syncwarp();
  T a[kNB];                       // lane i: row i of the block
#pragma unroll
  for (int c = 0; c < kNB; ++c) a[c] = S[lane][c];

  // right-looking column Cholesky on the lower triangle
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const T piv = rsqrt_t(__shfl_sync(kFull, a[j], j));
    if (lane >= j) a[j] *= piv;
#pragma unroll
    for (int k = j + 1; k < kNB; ++k) {
      const T lkj = __shfl_sync(kFull, a[j], k);      // L[k][j]
      if (lane >= k) a[k] -= a[j] * lkj;
    }
  }

  // forward substitution; lane j: column j of X = L^{-1}
  T x[kNB];
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < i; ++k) acc += __shfl_sync(kFull, a[k], i) * x[k];
    const T lii = __shfl_sync(kFull, a[i], i);
    x[i] = ((i == lane ? T(1) : T(0)) - acc) / lii;
  }

  // L, masked to the live lower triangle, out through the tile
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kNB; ++c)
    S[lane][c] = (lane < w && c < w && c <= lane) ? a[c] : T(0);
  __syncwarp();
  for (int r = 0; r < nb; ++r)
    if (lane < nb) Lout[base + (long long)r * nb + lane] = S[r][lane];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kNB; ++i) S[i][lane] = x[i];
  __syncwarp();
  for (int r = 0; r < nb; ++r)
    if (lane < nb) Linv[base + (long long)r * nb + lane] = S[r][lane];
}

template <typename T>
int launch(const void* wrel, const void* D, void* L, void* Linv, int B,
           int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    potrf_inv_kernel<T><<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
        (const int*)wrel, (const T*)D, (T*)L, (T*)Linv, nb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spfx_potrf_inv_f32(const void* wrel, const void* D, void* L,
                                  void* Linv, int B, int nb, void* stream) {
  return launch<float>(wrel, D, L, Linv, B, nb, stream);
}

extern "C" int spfx_potrf_inv_f64(const void* wrel, const void* D, void* L,
                                  void* Linv, int B, int nb, void* stream) {
  return launch<double>(wrel, D, L, Linv, B, nb, stream);
}
