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
// The column recurrence is the TPU kernel's: column j is scaled by the
// pivot p_j = rsqrt(d_jj) (the diagonal included), then the trailing lower
// triangle takes the rank-1 update. The inverse X = L^{-1} is formed
// right-looking, X[k, :] = acc[k, :] * p_k (p_k = 1 / L[k][k] up to
// rounding: a multiplication, not the TPU kernel's division), after which
// every later row takes its term -L[i][k] X[k, :]. A block with nb < 32 is
// treated as the leading part of a 32-wide block whose padding is the
// identity, which changes nothing on the first nb.
//
// What bounds it on the H100: memory. Per block of live width w it reads
// the w(w+1)/2 values of D's live lower triangle and writes 2*nb*nb values
// for ~2/3 w^3 operations (about 2 flop per byte in f32 at w = nb), far
// under the card's ridge, so the floor is those bytes over 3.35 TB/s.
// What stands between the kernel and that floor is one block's critical
// path, which no batch size hides: a launch takes about as long at B = 1
// as at 256. Timed in parts (spfx_torch/bench/kernel_probe.py potrf) on
// the NVIDIA H100 80GB HBM3 at 700 W, the one-warp design this replaces
// took 12.0 us a launch in f32 (17.9 in f64): half of it the inverse (a
// row-serial substitution, 496 dependent shuffles, every row ending in a
// division whose numerator was mostly zero, which sends the card's
// division to its slow path), a third staging and stores (each row's
// load waited for the previous row's store to shared memory; L and Linv
// left as 64 serial row stores).
//
// What the design does about it: one thread block of four warps per
// diagonal block, B blocks spread over the SMs, two 32 x 36 tiles in
// shared memory (36: rows stay 16-byte aligned, and a quarter warp's
// 16-byte row accesses fall in eight different bank groups).
//  - A block of width 0 writes L = 0 and Linv = I and ends.
//  - All 128 threads stage the live lower triangle, eight values each,
//    every load issued before any store to the tile.
//  - Warp 0 runs the column Cholesky in registers, lane i holding row i.
//    At step j every lane writes its column-j value to row j of the L^T
//    tile and, after a warp barrier, reads that row back as broadcast
//    16-byte reads: one store and eight reads a step where the one-warp
//    design shuffled up to 31 times. It keeps the pivots p_j in shared
//    memory (exactly 1 on the padding) and leaves L (masked) and L^T in
//    the tiles.
//  - Then warp 1 forms X = L^{-1}, lane j on column j, right-looking: a
//    step's path is one multiplication by the stored pivot and one
//    multiply-add, with no shuffle and no division; rows of L^T arrive as
//    broadcast 16-byte reads. Past the live width w the rows are the
//    identity's: the inverse stops at the first multiple of 8 steps
//    beyond it. Its rows leave straight from the registers, each a
//    coalesced row store. Meanwhile warps 0, 2 and 3 write L out from the
//    tile, by 16-byte stores where nb = 32.
// Measured on the card and not kept (kernel_probe with variant sources):
// the Cholesky's column by shuffles (the full-width launch 0.6-0.9 us
// slower, the 48^3 path 8.9 ms against 7.5); stopping the Cholesky, too,
// at the live width (a test every eight steps cut the straight-line
// code: the full-width block, which sets most launches' time, 0.8-1.3 us
// slower); running the inverse through every step (no gain).
// Templated on float and double.

#include <cuda_runtime.h>

#include "diag_block.cuh"

namespace {

using namespace diag_block;

constexpr int kS = 36;       // tile row stride
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here.
constexpr bool kChol = true, kInv = true;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// out[0 .. nb*nb) = the leading nb x nb part of a tile, row-major, by
// threads t, t + nt, ...: 16-byte stores given ``vec`` (nb = 32 and an
// aligned output: every block then starts on a 16-byte boundary), single
// values otherwise
template <typename T>
__device__ __forceinline__ void tile_out(T* out, const T* tile, int nb,
                                         bool vec, int t, int nt) {
  using V = Vec<T>;
  if (vec) {
    for (int q = t; q < kNB * kNB / V::n; q += nt) {
      const int r = q * V::n / kNB, c = q * V::n % kNB;
      ((typename V::type*)out)[q] =
          *(const typename V::type*)(tile + r * kS + c);
    }
  } else {
    for (int e = t; e < nb * nb; e += nt) out[e] = tile[e / nb * kS + e % nb];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
potrf_inv_kernel(const int* __restrict__ wrel, const T* __restrict__ D,
                 T* __restrict__ Lout, T* __restrict__ Linv, int nb,
                 bool vec) {
  __shared__ __align__(16) T LL[kNB * kS];   // D', then L masked
  __shared__ __align__(16) T LT[kNB * kS];   // L^T
  __shared__ T P[kNB];                       // pivots p_j
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = (long long)blockIdx.x * nb * nb;
  int w = wrel[blockIdx.x];
  w = w < 0 ? 0 : (w > nb ? nb : w);

  if (w == 0) {
    for (int e = tid; e < nb * nb; e += kThreads) {
      Lout[base + e] = T(0);
      Linv[base + e] = e / nb == e % nb ? T(1) : T(0);
    }
    return;
  }

  // stage: the lower triangle of the live block, identity on the padding
  {
    constexpr int kPer = kNB * kNB / kThreads;
    T v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads, r = e / kNB, c = e % kNB;
      v[j] = (r < w && c <= r) ? D[base + (long long)r * nb + c]
                               : (r == c ? T(1) : T(0));
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      LL[(e / kNB) * kS + e % kNB] = v[j];
    }
  }
  __syncthreads();

  if (warp == 0) {
    // right-looking column Cholesky, lane i holding row i, column j
    // passed through row j of LT; steps j >= w change nothing (the rows and
    // columns there are the identity's) and the pivots there are set to 1
    T a[kNB];
    T p = T(1);                                       // lane j: p_j
    ld_from(LL + lane * kS, 0, a);
    if (kChol) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        LT[j * kS + lane] = a[j];                     // column j, unscaled
        __syncwarp();
        T col[kNB];
        ld_from(LT + j * kS, j, col);
        const T piv = rsqrt_t(col[j]);
        if (lane >= j) a[j] *= piv;
        p = lane == j ? piv : p;
#pragma unroll
        for (int k = j + 1; k < kNB; ++k)
          if (lane >= k) a[k] -= a[j] * (col[k] * piv);
      }
      __syncwarp();
    }
    P[lane] = lane < w ? p : T(1);
#pragma unroll
    for (int c = 0; c < kNB; ++c) LT[c * kS + lane] = a[c];
    if (lane >= w) {
#pragma unroll
      for (int c = 0; c < kNB; ++c) a[c] = T(0);
    }
    st_row(LL + lane * kS, a);
  }
  __syncthreads();

  if (warp == 1) {
    // X = L^{-1}, lane j on column j: acc[i] = e_i[j] - sum_{k<i} L[i][k]
    // X[k][j], each term taken as soon as X[k][j] = acc[k] p_k is known;
    // steps k >= w leave the identity's rows as they are
    T acc[kNB];
    unit_row(acc, lane);
    if (kInv) {
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        if (k % 8 == 0 && k >= w) break;
        acc[k] *= P[k];
        T l[kNB];                                    // L[k+1.., k]
        ld_from(LT + k * kS, k + 1, l);
#pragma unroll
        for (int i = k + 1; i < kNB; ++i) acc[i] -= l[i] * acc[k];
      }
    }
    if (lane < nb) {
#pragma unroll
      for (int i = 0; i < kNB; ++i)
        if (i < nb) Linv[base + (long long)i * nb + lane] = acc[i];
    }
  } else {
    tile_out(Lout + base, LL, nb, vec, warp == 0 ? lane : tid - 32, 96);
  }
}

template <typename T>
int launch(const void* wrel, const void* D, void* L, void* Linv, int B,
           int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const bool vec = nb == kNB && (size_t)L % 16 == 0;
    potrf_inv_kernel<T><<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)wrel, (const T*)D, (T*)L, (T*)Linv, nb, vec);
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
