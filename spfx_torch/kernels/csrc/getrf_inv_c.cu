// Batched no-pivot LU + explicit inverses of small COMPLEX diagonal blocks,
// complex64 and complex128, sm_90a.
//
// No Pallas kernel computes it: the JAX package routes complex panels away
// from getrf_inv_lanes (spfx/kernels/pallas_blocks.py, f32 only) to XLA's
// no-pivot LU (spfx/kernels/blocks.py, ``_lu_deltas_blocks``). The port's
// blocked LU panel path (spfx_torch/kernels/blocks.py) runs every type
// through one diagonal-block contract (spfx_torch/kernels/panel.py's
// docstring), so complex blocks take this kernel beside the real one
// (getrf_inv.cu), task-major (B, nb, nb) row-major blocks, nb <= 32, with
// valid width w = clamp(wrel[b], 0, nb):
//   D'   = D on rows/cols < w (both triangles), identity on the padding;
//   L, U = the no-pivot LU of D' (L unit lower, complex division, nothing
//          conjugated), both zeroed on the padding (w = 0: L = U = 0);
//   Linv = L^{-1} of the unmasked unit L, Uinv = U^{-1} of the unmasked U;
//          both are the identity on the padding (w = 0: I).
// The recurrences are the plain version's (getrf_inv_plain): right-looking
// elimination, lcol = a_ik / a_kk, then the rank-1 update of the trailing
// block; Linv as the forward substitution X[i, :] = e_i - L[i, :i] X[:i, :];
// Uinv as the transpose of Y = (U^T)^{-1}, Y[i, :] = (e_i - U^T[i, :i]
// Y[:i, :]) / U[i, i]. Both substitutions add their terms in k order, each
// as soon as X[k, :] or Y[k, :] is known.
//
// What bounds it on the H100: memory, as for the real kernel. Per block of
// live width w it reads w^2 complex values and writes 4 nb^2 for about
// 4 x 4/3 w^3 real operations, a few flop per byte, far under the card's
// ridge. What stands between the kernel and that floor is one block's
// critical path, which no batch size hides: the one-warp design this
// replaces (formerly in diag_block_c.cu) took about as long at B = 1 as at
// B = 256, its lanes loading rows one after another, eliminating through
// shared memory, running all nb steps whatever the live width, and forming
// both inverses on the same warp, each row of Uinv ending in a Smith
// division.
//
// What the design does about it: getrf_inv.cu's design, over complex
// values, with what the card showed (kernel_probe.py getrf_c, its cuts
// and the copies below) changed. One thread block of four warps per
// diagonal block, B blocks spread over the SMs, four 32 x kS tiles in
// shared memory (kS keeps rows 16-byte aligned and puts the 16-byte row
// accesses of a quarter warp in eight different bank groups).
//  - All 128 threads stage the block, eight values each, every load issued
//    before any store to the tile.
//  - Warp 0 eliminates in registers, lane i holding row i. Row k is final
//    at step k: lane k writes it to the tile, and the other lanes read it
//    back as broadcast 16-byte reads (a complex64 value by shuffles is two
//    of them, and the shuffled form measured 20% slower). Each lane forms
//    the reciprocal of its next pivot as soon as that value is final,
//    while the step finishes, so that lane k publishes it with its row.
//    It leaves LU (row-major), L^T and each pivot's reciprocal in shared
//    memory.
//  - Then warp 1 forms Linv and warp 2 Uinv side by side, lane j on column
//    j of X or Y, right-looking: as soon as X[k][j] (or Y[k][j], one
//    complex product by the pivot's reciprocal) is known, every later
//    row's sum takes its term. Their loops are rolled: the registers
//    shift one place a step (acc[p] holds row k + p at step k), so one
//    loop body serves every step and each step updates only the 8-row
//    chunks that hold live rows. Unrolled as in getrf_inv.cu, the two
//    inverses took 9.1 us of a complex64 launch at full width, against
//    3.3 rolled (NVIDIA H100 80GB HBM3): the unrolled complex kernel's
//    code is about three times the real one's, and run once a block it
//    streams in rather than runs from the instruction cache.
//    Meanwhile warps 0 and 3 write L and U out.
//  - All four warps write Linv and Uinv out, coalesced.
//  - Past the live width the chains are the identity's and change
//    nothing: the elimination stops at the first multiple of 8 steps past
//    it, the inverses at the width itself.
//
// The division. Every division in the kernel is by a pivot p, the same
// for every lane, so the kernel forms p's reciprocal once and multiplies,
// by Smith's scaling: with big and small p's larger and smaller parts,
// r = small / big and s = 1 / (big + small r), 1/p = (s, -r s) when
// |Re p| >= |Im p|, else (r s, -s); a / p = a (1/p). |p|^2 is never
// formed, so a pivot whose square leaves the type's range (complex64
// blocks scaled by 2^70 or 2^-70) divides as well as any. On the
// elimination's critical path r and s come from the card's reciprocal
// (rcp.approx, refined by one Newton step in complex64, two in
// complex128: recip_fast), a few units in the last place from the
// quotients; where big or big + small r lies outside [2^-125, 2^126)
// (complex64) or [2^-1021, 2^1022) (complex128), where that reciprocal
// flushes, lane k forms them again with recip. recip, which also gives
// Uinv its reciprocals, divides: complex64 with the card's division
// sequence (diag_block.cuh's ``quot``, exact while the operands stay
// within 2^+-87; the IEEE division beyond), complex128 with the IEEE
// division. Either way the result differs from Smith's a / p (and from
// torch's complex division, which is Smith's with the quotient by the
// scale taken as a product with s) by the roundings of 1/p and of the
// product, a few units in the last place.
//
// Templated on float (complex64) and double (complex128). complex128 rows
// are 128 32-bit registers: the compiler keeps them without spilling
// (174 registers a thread, no local memory), so the complex128 form has
// the same arrangement.

#include <cuda_runtime.h>

#include "diag_block.cuh"

namespace {

using diag_block::kNB;
using diag_block::quot;
using diag_block::rcp_nr;

constexpr int kThreads = 128;
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here.
constexpr bool kElimC = true, kLinvC = true, kUinvC = true;

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T re, im;
};

// tile row stride in complex values: rows 16-byte aligned, and the 16-byte
// accesses of eight lanes to eight rows in eight different bank groups
template <typename T>
struct RowStride {
  static constexpr int v = sizeof(T) == 4 ? 34 : 33;
};

template <typename T>
__device__ __forceinline__ Cx<T> unit(bool one) {
  return {one ? T(1) : T(0), T(0)};
}

// a - l u
template <typename T>
__device__ __forceinline__ Cx<T> cfms(Cx<T> a, Cx<T> l, Cx<T> u) {
  a.re = fma(-l.re, u.re, a.re);
  a.re = fma(l.im, u.im, a.re);
  a.im = fma(-l.re, u.im, a.im);
  a.im = fma(-l.im, u.re, a.im);
  return a;
}

template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {fma(a.re, b.re, -a.im * b.im), fma(a.re, b.im, a.im * b.re)};
}

// 1 / p by Smith's scaling (see the header): r and s by the card's
// division sequence where it is exact, else by the IEEE division
__device__ __forceinline__ Cx<float> recip(Cx<float> p) {
  const bool rm = fabsf(p.re) >= fabsf(p.im);
  const float big = rm ? p.re : p.im, small = rm ? p.im : p.re;
  bool off = false;
  float r = quot<false>(small, big, rcp_nr(big), off);
  float d = fmaf(small, r, big);
  float s = quot<false>(1.0f, d, rcp_nr(d), off);
  if (off) {
    r = small / big;
    d = fmaf(small, r, big);
    s = 1.0f / d;
  }
  return rm ? Cx<float>{s, -r * s} : Cx<float>{r * s, -s};
}

__device__ __forceinline__ Cx<double> recip(Cx<double> p) {
  const bool rm = fabs(p.re) >= fabs(p.im);
  const double big = rm ? p.re : p.im, small = rm ? p.im : p.re;
  const double r = small != 0.0 ? small / big : 0.0;
  const double s = 1.0 / fma(small, r, big);
  return rm ? Cx<double>{s, -r * s} : Cx<double>{r * s, -s};
}

// 1 / p from the card's reciprocal refined by Newton steps, no division;
// ``off`` where p's larger part or the scale d leaves the range in which
// the approximate reciprocal is exact to a few units (then the caller
// takes recip)
__device__ __forceinline__ float rcp_fast(float x) { return rcp_nr(x); }
__device__ __forceinline__ double rcp_fast(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  double e = fma(-x, r, 1.0);
  r = fma(r, e, r);
  e = fma(-x, r, 1.0);
  return fma(r, e, r);
}
__device__ __forceinline__ bool out_of_range(float x) {
  return ((__float_as_uint(x) >> 23) & 0xffu) - 2u > 250u;
}
__device__ __forceinline__ bool out_of_range(double x) {
  return ((unsigned)(__double_as_longlong(x) >> 52) & 0x7ffu) - 2u > 2042u;
}
template <typename T>
__device__ __forceinline__ Cx<T> recip_fast(Cx<T> p, bool& off) {
  const bool rm = fabs(p.re) >= fabs(p.im);
  const T big = rm ? p.re : p.im, small = rm ? p.im : p.re;
  const T r = small * rcp_fast(big);
  const T d = fma(small, r, big);
  const T s = rcp_fast(d);
  off = out_of_range(big) || out_of_range(d);
  return rm ? Cx<T>{s, -r * s} : Cx<T>{r * s, -s};
}

// 16-byte vectors of complex values: two complex64, one complex128
template <typename T> struct CV;
template <> struct CV<float> {
  using type = float4;
  static constexpr int n = 2;
  __device__ static void get(float4 v, Cx<float>* o) {
    o[0] = {v.x, v.y};
    o[1] = {v.z, v.w};
  }
  __device__ static float4 make(const Cx<float>* o) {
    return make_float4(o[0].re, o[0].im, o[1].re, o[1].im);
  }
};
template <> struct CV<double> {
  using type = double2;
  static constexpr int n = 1;
  __device__ static void get(double2 v, Cx<double>* o) { o[0] = {v.x, v.y}; }
  __device__ static double2 make(const Cx<double>* o) {
    return make_double2(o[0].re, o[0].im);
  }
};

// out[c] = row[c] for c from lo (rounded down to a vector) to kNB
template <typename T>
__device__ __forceinline__ void ld_from(const Cx<T>* row, int lo, Cx<T>* out) {
  using V = CV<T>;
#pragma unroll
  for (int q = lo / V::n; q < kNB / V::n; ++q)
    V::get(((const typename V::type*)row)[q], out + q * V::n);
}

template <typename T>
__device__ __forceinline__ void st_row(Cx<T>* row, const Cx<T>* v) {
  using V = CV<T>;
#pragma unroll
  for (int q = 0; q < kNB / V::n; ++q)
    ((typename V::type*)row)[q] = V::make(v + q * V::n);
}

constexpr int kChunk = 8;     // rows an inverse's step updates per branch

template <typename T>
__device__ __forceinline__ void unit_row(Cx<T> (&acc)[kNB], int lane) {
#pragma unroll
  for (int i = 0; i < kNB; ++i) acc[i] = unit<T>(i == lane);
}

template <typename T>
constexpr size_t smem_bytes() {
  return 4u * kNB * RowStride<T>::v * sizeof(Cx<T>);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
getrf_inv_c_kernel(const int* __restrict__ wrel, const Cx<T>* __restrict__ D,
                   Cx<T>* __restrict__ Lout, Cx<T>* __restrict__ Uout,
                   Cx<T>* __restrict__ Linv, Cx<T>* __restrict__ Uinv,
                   int nb) {
  using C = Cx<T>;
  constexpr int kS = RowStride<T>::v;
  extern __shared__ __align__(16) unsigned char smem[];
  C* LU = reinterpret_cast<C*>(smem);   // L below the diagonal, U on it
  C* LT = LU + kNB * kS;                // L^T
  C* XI = LT + kNB * kS;                // Linv
  C* UI = XI + kNB * kS;                // Uinv
  __shared__ C PI[kNB];                 // 1 / U[k][k]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = (long long)blockIdx.x * nb * nb;
  int w = wrel[blockIdx.x];
  w = w < 0 ? 0 : (w > nb ? nb : w);

  // stage: the live block, both triangles, identity on the padding
  {
    constexpr int kPer = kNB * kNB / kThreads;
    C v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads, r = e / kNB, c = e % kNB;
      v[j] = (r < w && c < w) ? D[base + (long long)r * nb + c]
                              : unit<T>(r == c);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      LU[(e / kNB) * kS + e % kNB] = v[j];
    }
  }
  __syncthreads();

  if (warp == 0) {
    // right-looking no-pivot elimination, lane i holding row i: after step
    // k, lane i > k holds L[i][k] in a[k], and lane k holds U's row k in
    // a[k..]. Steps k >= w - 1 change nothing (the rows below are the
    // identity's) and are skipped.
    C a[kNB];
    ld_from(LU + lane * kS, 0, a);
    if (kElimC) {
      bool off;
      C own = recip_fast(a[0], off);   // lane k: 1 / U[k][k], once final
#pragma unroll
      for (int k = 0; k < kNB - 1; ++k) {
        if (k % 8 == 0 && k >= w - 1) break;
        if (lane == k) {               // row k is final: publish it
          if (off) own = recip(a[k]);
          st_row(LU + k * kS, a);
          PI[k] = own;
        }
        __syncwarp();
        C u[kNB];                      // U[k][k+1..]
        ld_from(LU + k * kS, k + 1, u);
        C lcol = cmul(a[k], PI[k]);
        if (lane <= k) lcol = unit<T>(false);
#pragma unroll
        for (int j = k + 1; j < kNB; ++j) {
          a[j] = cfms(a[j], lcol, u[j]);
          if (j == k + 1) own = recip_fast(a[k + 1], off);
        }
        if (lane > k) a[k] = lcol;
      }
    }
    st_row(LU + lane * kS, a);
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (c < lane) LT[c * kS + lane] = a[c];
    __syncwarp();
    PI[lane] = recip(LU[lane * kS + lane]);
  }
  __syncthreads();

  if (warp == 1) {
    // Linv, lane j on column j of X, right-looking: acc[p] holds X[k + p][j]
    // at step k (one place shifted a step, so that one rolled loop body
    // serves every step: unrolled, the inverses' code outgrew the
    // instruction cache). X[k][j] is final at step k, and every later
    // live row takes its term, 8 rows a branch; the rows past the live
    // width are the identity's.
    C acc[kNB];
    unit_row(acc, lane);
    const int kend = kLinvC ? w : 0;
#pragma unroll 1
    for (int k = 0; k < kend; ++k) {
      const C x = acc[0];
      XI[k * kS + lane] = x;
      const C* l = LT + k * kS + k + 1;               // L[k + 1 + q][k]
#pragma unroll
      for (int c = 0; c < kNB; c += kChunk) {
        if (c >= w - k) break;
#pragma unroll
        for (int p = 0; p < kChunk; ++p)
          if (c + p + 1 < kNB) acc[c + p] = cfms(acc[c + p + 1], l[c + p], x);
      }
    }
    for (int r = kend; r < kNB; ++r) XI[r * kS + lane] = unit<T>(r == lane);
  } else if (warp == 2) {
    // Y = (U^T)^{-1}, lane j on column j of Y (row j of Uinv), shifted
    // the same way: Y[k][j] = acc[0] / U[k][k], then every later live row
    // takes its term; the rows past the live width are the identity's
    C acc[kNB];
    unit_row(acc, lane);
    const int kend = kUinvC ? w : 0;
#pragma unroll 1
    for (int k = 0; k < kend; ++k) {
      const C y = cmul(acc[0], PI[k]);
      UI[lane * kS + k] = y;
      const C* u = LU + k * kS + k + 1;               // U[k][k + 1 + q]
#pragma unroll
      for (int c = 0; c < kNB; c += kChunk) {
        if (c >= w - k) break;
#pragma unroll
        for (int p = 0; p < kChunk; ++p)
          if (c + p + 1 < kNB) acc[c + p] = cfms(acc[c + p + 1], u[c + p], y);
      }
    }
    for (int r = kend; r < kNB; ++r) UI[lane * kS + r] = unit<T>(r == lane);
  } else {
    // L (unit lower) and U, masked to the live block, out by warps 0, 3
    const int t = warp == 0 ? lane : 32 + lane;
    for (int e = t; e < nb * nb; e += 64) {
      const int r = e / nb, c = e % nb;
      const C x = LU[r * kS + c];
      const bool live = r < w && c < w;
      Lout[base + e] = live ? (c < r ? x : unit<T>(c == r)) : unit<T>(false);
      Uout[base + e] = live && c >= r ? x : unit<T>(false);
    }
  }
  __syncthreads();

  for (int e = tid; e < nb * nb; e += kThreads) {
    const int r = e / nb, c = e % nb;
    Linv[base + e] = XI[r * kS + c];
    Uinv[base + e] = UI[r * kS + c];
  }
}

template <typename T>
int launch(const void* wrel, const void* D, void* L, void* U, void* Linv,
           void* Uinv, int B, int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  constexpr size_t kSmem = smem_bytes<T>();
  // above 48 KB only after the opt-in, set once (before any capture: the
  // callers' first launch is eager)
  static bool opted = false;
  if (!opted && kSmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        getrf_inv_c_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  opted = true;
  if (B > 0) {
    getrf_inv_c_kernel<T><<<(unsigned)B, kThreads, kSmem,
                            (cudaStream_t)stream>>>(
        (const int*)wrel, (const Cx<T>*)D, (Cx<T>*)L, (Cx<T>*)U,
        (Cx<T>*)Linv, (Cx<T>*)Uinv, nb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spfx_getrf_inv_c64(const void* wrel, const void* D, void* L,
                                  void* U, void* Linv, void* Uinv, int B,
                                  int nb, void* stream) {
  return launch<float>(wrel, D, L, U, Linv, Uinv, B, nb, stream);
}

extern "C" int spfx_getrf_inv_c128(const void* wrel, const void* D, void* L,
                                   void* U, void* Linv, void* Uinv, int B,
                                   int nb, void* stream) {
  return launch<double>(wrel, D, L, U, Linv, Uinv, B, nb, stream);
}
