// Batched Cholesky of small SPD matrices, for sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py cholesky_small_batched: on the TPU
// a slab of matrices sits in VMEM and the column recurrence runs across
// the slab at once, column j pulled out with a one-hot contraction.
//
// What it computes, per matrix b of D (batch, c, c), c <= 32, row-major:
// the lower Cholesky factor L of the SPD matrix whose lower triangle is
// D[b]'s (the upper triangle is never read), with exact zeros above the
// diagonal. The recurrence is the TPU kernel's: column j is scaled by
// rsqrt(d_jj) (the diagonal included), then the trailing lower triangle
// takes the rank-1 update. A non-positive pivot gives NaN, as rsqrt does
// on the TPU; nothing is checked.
//
// What bounds it on the H100: memory. Per matrix it reads the c(c+1)/2
// values of the lower triangle and writes c^2 for c^3/3 flops (under 2
// flop a byte in f32 at c = 32), so the floor is those bytes over
// 3.35 TB/s. Between the kernel and that floor stand c dependent column
// steps per matrix, a latency chain.
//
// What the design does about it: the design of potrf_inv.cu without its
// masks and inverse. One warp per matrix, four matrices per thread block.
// The matrix moves between device memory and a (32 x 33) shared-memory
// tile with row loads and stores (lane = column); in between it lives in
// registers, lane i holding row i, the loop fully unrolled, and the pivot
// column's entries reach the other rows by warp shuffle. A matrix with
// c < 32 is the leading block of a 32 x 32 matrix whose padding is the
// identity, which changes nothing on the first c rows and columns.
// Templated on float and double.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;
constexpr int kLd = kC + 1;
constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
chol_small_kernel(const T* __restrict__ D, T* __restrict__ Lout, int batch,
                  int c) {
  __shared__ T tiles[kWarps][kC][kLd];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long mat = (long long)blockIdx.x * kWarps + warp;
  if (mat >= batch) return;         // the whole warp: no block barrier below
  T(*S)[kLd] = tiles[warp];
  const long long base = mat * c * c;

  // stage: the lower triangle, identity on the padding
  for (int r = 0; r < kC; ++r) {
    T v = T(0);
    if (r < c) {
      if (lane <= r) v = D[base + (long long)r * c + lane];
    } else if (r == lane) {
      v = T(1);
    }
    S[r][lane] = v;
  }
  __syncwarp();
  T a[kC];                          // lane i: row i
#pragma unroll
  for (int col = 0; col < kC; ++col) a[col] = S[lane][col];

  // right-looking column Cholesky on the lower triangle
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const T piv = rsqrt_t(__shfl_sync(kFull, a[j], j));
    if (lane >= j) a[j] *= piv;
#pragma unroll
    for (int q = j + 1; q < kC; ++q) {
      const T lqj = __shfl_sync(kFull, a[j], q);      // L[q][j]
      if (lane >= q) a[q] -= a[j] * lqj;
    }
  }

  // L, zero above the diagonal, out through the tile
  __syncwarp();
#pragma unroll
  for (int col = 0; col < kC; ++col) S[lane][col] = col <= lane ? a[col] : T(0);
  __syncwarp();
  for (int r = 0; r < c; ++r)
    if (lane < c) Lout[base + (long long)r * c + lane] = S[r][lane];
}

template <typename T>
int launch(const void* D, void* L, int batch, int c, void* stream) {
  if (batch < 0 || c < 1 || c > kC) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const unsigned blocks = (unsigned)((batch + kWarps - 1) / kWarps);
    chol_small_kernel<T><<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const T*)D, (T*)L, batch, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// L (batch, c, c) = the lower Cholesky factors of D's lower triangles,
// c <= 32; with batch == 0 nothing is launched. Returns cudaGetLastError().
extern "C" int spfx_cholesky_small_batched_f32(const void* D, void* L,
                                               int batch, int c,
                                               void* stream) {
  return launch<float>(D, L, batch, c, stream);
}

extern "C" int spfx_cholesky_small_batched_f64(const void* D, void* L,
                                               int batch, int c,
                                               void* stream) {
  return launch<double>(D, L, batch, c, stream);
}
