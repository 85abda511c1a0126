// Batched Hermitian Cholesky + explicit inverse of small COMPLEX diagonal
// blocks (potrf_inv_c), complex64 and complex128, sm_90a. Its LU twin is
// getrf_inv_c.cu, its real twin potrf_inv.cu.
//
// No Pallas kernel computes it: the JAX package routes complex panels
// away from its diagonal-block kernels (potrf_inv_lanes in
// spfx/kernels/pallas_blocks.py takes f32 only) to XLA's Cholesky
// (spfx/kernels/blocks.py, ``_chol_deltas_blocks``: ``not
// jnp.iscomplexobj``). The port's blocked panel path
// (spfx_torch/kernels/blocks.py) runs every type through one
// diagonal-block contract (spfx_torch/kernels/panel.py's docstring),
// task-major (B, nb, nb) row-major blocks, nb <= 32, with valid width
// w = clamp(wrel[b], 0, nb):
//   D'   = D's lower triangle on rows/cols < w (Hermitian: the upper
//          triangle is never read), identity on the padding;
//   L    = chol(D') with L L^H = D' and real positive pivots (the real
//          part of each diagonal entry is taken, and L's diagonal is
//          stored real), zeroed on the padding (w = 0: L = 0);
//   Linv = L^{-1}, unit rows on the padding (w = 0: I).
// The recurrences are those of the plain version (potrf_inv_plain): the
// right-looking column Cholesky, column j scaled by p_j = rsqrt(Re d_jj),
// then the trailing lower triangle takes -L[i][j] conj(L[k][j]); the
// inverse X = L^{-1} formed right-looking, X[k][:] = acc[k][:] p_k (p_k is
// 1 / L[k][k] up to rounding: a real scale, not the plain version's
// division), after which every later row takes -L[i][k] X[k][:].
//
// What bounds it on the H100: memory. Per block of live width w it reads
// the w(w+1)/2 complex values of D's live lower triangle and writes
// 2 nb^2, for about 4 x 2/3 w^3 real operations: a few flop per byte, far
// under the card's ridge. What stands between the kernel and that floor
// is one block's critical path, which no batch size hides. The one-warp
// design this replaces (formerly diag_block_c.cu) took 44.3 us at the
// complex64 48^3 Cholesky plan's largest call (B = 256, nearly every
// block of width <= 1) and about as long at B = 1: its warp staged the
// block row by row, ran all nb elimination steps whatever the live
// width, through shared memory, then formed the inverse row-serially on
// the same warp, each row ending in a division.
//
// What the design does about it: potrf_inv.cu's design over complex
// values, with what getrf_inv_c.cu measured for complex arithmetic, and
// the inverse run beside the elimination. One thread block of four warps
// per diagonal block, B blocks spread over the SMs, two 32 x kS tiles in
// shared memory (kS keeps rows 16-byte aligned and puts the 16-byte row
// accesses of a quarter warp in eight different bank groups).
//  - A block of width 0 writes L = 0 and Linv = I and ends.
//  - All 128 threads stage the live lower triangle, eight values each,
//    every load issued before any store to the tile.
//  - Warp 0 runs the column Cholesky in registers, lane i holding row i.
//    At step j every lane writes its column-j value, conjugated and
//    unscaled, to row j of the L^H tile, and lane j its pivot p_j, formed
//    as soon as its diagonal entry was final (so rsqrt is off the step's
//    chain), to P[j]; after a warp barrier the lanes read the row back as
//    broadcast 16-byte reads, 8 columns at a time (getrf_inv_c.cu
//    measured shuffles 20% slower for complex64). Each lane takes
//    a[k] -= (a[j] p_j^2) conj(a_kj), four multiply-adds a term, on every
//    column right of j: the terms above the diagonal are junk, masked
//    once at the end (predicated on the lane, complex128 took 12.60 us at
//    B = 1, against 10.64).
//    Steps past the live width change nothing (the rows there are the
//    identity's): the elimination stops at the first multiple of 8 steps
//    past it. Warp 0 then leaves L (masked) in the other tile.
//  - Warp 1 forms X = L^{-1} meanwhile, lane j on column j, right-looking,
//    step k as soon as warp 0 has published row k of L^H and p_k (a
//    counter in shared memory, a block-scope fence before each store of
//    it; an acquire load in its place measured 0.7 us slower):
//    X[k][j] = acc p_k, a real scale and no division, then every later
//    live row takes a_ik (p_k X[k][j]), 8 rows a branch. Run after the
//    elimination, as first written, the inverse took about 4.5 of 14.2 us
//    at B = 1 (complex64); beside it, 2.4 of 8.6. The loop is rolled, the
//    registers shifting one place a step (acc[q] holds row k + q at step
//    k): unrolled, getrf_inv_c.cu's complex inverses took 9.1 us of a
//    launch against 3.3 rolled, the larger code streaming from the
//    instruction cache. It stops at the live width. Its rows leave
//    straight from the registers, each a coalesced row store, as
//    potrf_inv.cu's do (no third tile and no barrier before them).
//  - Warps 0, 2 and 3 then write L out from the tile (a named barrier of
//    the three), by 16-byte stores where nb = 32.
// Measured on the card (kernel_probe.py potrf_c, NVIDIA H100 80GB HBM3,
// 700 W), complex64 at B = 1 on a width-32 block of the 48^3 Cholesky
// plan: 8.6 us, of which 2.1 staging and stores, about 4.1 the
// elimination's chain of 32 steps and 2.4 the inverse's tail; not kept:
// an aligned shifted copy of each column for the inverse's reads (9.1),
// publishing every second step (9.3).
//
// Templated on float (complex64) and double (complex128).

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 32;
constexpr int kThreads = 128;
constexpr int kChunk = 8;     // rows (columns) a step updates per branch
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here.
constexpr bool kCholC = true, kInvC = true;

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

template <typename T>
__device__ __forceinline__ Cx<T> cconj(Cx<T> a) {
  return {a.re, -a.im};
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

// a - conj(l) u
template <typename T>
__device__ __forceinline__ Cx<T> cfms_conj(Cx<T> a, Cx<T> l, Cx<T> u) {
  a.re = fma(-l.re, u.re, a.re);
  a.re = fma(-l.im, u.im, a.re);
  a.im = fma(-l.re, u.im, a.im);
  a.im = fma(l.im, u.re, a.im);
  return a;
}

template <typename T>
__device__ __forceinline__ Cx<T> cscale(Cx<T> a, T s) {
  return {a.re * s, a.im * s};
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

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

// out[c] = row[c], c < kNB (row 16-byte aligned)
template <typename T>
__device__ __forceinline__ void ld_row(const Cx<T>* row, Cx<T>* out) {
  using V = CV<T>;
#pragma unroll
  for (int q = 0; q < kNB / V::n; ++q)
    V::get(((const typename V::type*)row)[q], out + q * V::n);
}

// out[q] = row[q], q < kChunk (row 16-byte aligned)
template <typename T>
__device__ __forceinline__ void ld_chunk(const Cx<T>* row, Cx<T>* out) {
  using V = CV<T>;
#pragma unroll
  for (int q = 0; q < kChunk / V::n; ++q)
    V::get(((const typename V::type*)row)[q], out + q * V::n);
}

template <typename T>
__device__ __forceinline__ void st_row(Cx<T>* row, const Cx<T>* v) {
  using V = CV<T>;
#pragma unroll
  for (int q = 0; q < kNB / V::n; ++q)
    ((typename V::type*)row)[q] = V::make(v + q * V::n);
}

// out[0 .. nb*nb) = the leading nb x nb part of a tile, row-major, by
// threads t, t + nt, ...: 16-byte stores given ``vec`` (nb = 32 and an
// aligned output: every block then starts on a 16-byte boundary), single
// values otherwise
template <typename T>
__device__ __forceinline__ void tile_out(Cx<T>* out, const Cx<T>* tile,
                                         int nb, bool vec, int t, int nt) {
  using V = CV<T>;
  constexpr int kS = RowStride<T>::v;
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
potrf_inv_c_kernel(const int* __restrict__ wrel, const Cx<T>* __restrict__ D,
                   Cx<T>* __restrict__ Lout, Cx<T>* __restrict__ Linv,
                   int nb, bool vec) {
  using C = Cx<T>;
  constexpr int kS = RowStride<T>::v;
  __shared__ __align__(16) C LL[kNB * kS];   // D', then L masked
  __shared__ __align__(16) C LH[kNB * kS];   // row j: column j conjugated
  __shared__ T P[kNB];                       // pivots p_j
  __shared__ int ready;                      // LH rows and P published
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = (long long)blockIdx.x * nb * nb;
  int w = wrel[blockIdx.x];
  w = w < 0 ? 0 : (w > nb ? nb : w);

  if (w == 0) {
    for (int e = tid; e < nb * nb; e += kThreads) {
      Lout[base + e] = unit<T>(false);
      Linv[base + e] = unit<T>(e / nb == e % nb);
    }
    return;
  }

  // stage: the lower triangle of the live block, identity on the padding
  {
    constexpr int kPer = kNB * kNB / kThreads;
    C v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads, r = e / kNB, c = e % kNB;
      v[j] = (r < w && c <= r) ? D[base + (long long)r * nb + c]
                               : unit<T>(r == c);
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      LL[(e / kNB) * kS + e % kNB] = v[j];
    }
    if (tid == 0) ready = 0;
  }
  __syncthreads();

  if (warp == 0) {
    // right-looking column Cholesky, lane i holding row i: at step j the
    // column goes conjugated and unscaled to row j of LH, lane j's pivot
    // p_j = rsqrt(Re a_jj) (formed as soon as a_jj was final) to P[j];
    // both are published to warp 1. Then a[k] -= (a[j] p_j^2) conj(a_kj)
    // = L[i][j] conj(L[k][j]) for every k > j (junk where k > i, masked
    // at the end), and a[j] becomes L[i][j]. Steps j >= w change nothing
    // and are skipped from the first multiple of 8 on.
    C a[kNB];
    ld_row(LL + lane * kS, a);
    T nxt = rsqrt_t(a[0].re);                    // lane j: p_j
    if (kCholC) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        if (j % 8 == 0 && j >= w) break;
        LH[j * kS + lane] = cconj(a[j]);
        if (lane == j) P[j] = nxt;
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          *(volatile int*)&ready = j + 1;
        }
        const T piv = P[j];
        const C m = cscale(a[j], piv * piv);
        if (lane >= j) a[j] = lane == j ? C{a[j].re * piv, T(0)}
                                        : cscale(a[j], piv);
#pragma unroll
        for (int c = 0; c < kNB; c += kChunk) {
          if (c + kChunk <= j + 1) continue;
          C col[kChunk];                         // conj(a_kj), k = c + q
          ld_chunk(LH + j * kS + c, col);
#pragma unroll
          for (int q = 0; q < kChunk; ++q) {
            const int k = c + q;
            if (k > j) a[k] = cfms(a[k], m, col[q]);
            if (k == j + 1) nxt = rsqrt_t(a[k].re);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) {            // every step published (cut copies too)
      __threadfence_block();
      *(volatile int*)&ready = kNB;
    }
#pragma unroll
    for (int c = 0; c < kNB; ++c)
      if (lane >= w || c > lane) a[c] = unit<T>(false);
    st_row(LL + lane * kS, a);
  } else if (warp == 1) {
    // X = L^{-1}, lane j on column j, right-looking, step k as soon as
    // warp 0 has published column k: acc[q] holds X[k + q][j] at step k
    // (one place shifted a step, so that one rolled loop body serves every
    // step). X[k][j] = acc[0] p_k is final at step k and leaves for Linv;
    // every later live row takes L[i][k] X[k][j] = a_ik (p_k X[k][j]), 8
    // rows a branch. The rows past the live width are the identity's.
    C acc[kNB];
#pragma unroll
    for (int i = 0; i < kNB; ++i) acc[i] = unit<T>(i == lane);
    const bool out = lane < nb;
    const int kend = kInvC ? w : 0;
#pragma unroll 1
    for (int k = 0; k < kend; ++k) {
      while (*(volatile int*)&ready <= k) {
      }
      __threadfence_block();
      const T pk = P[k];
      const C x = cscale(acc[0], pk);
      if (out) Linv[base + (long long)k * nb + lane] = x;
      const C y = cscale(x, pk);
      const C* l = LH + k * kS + k + 1;          // conj(a_{k+1+q, k})
#pragma unroll
      for (int c = 0; c < kNB; c += kChunk) {
        if (c >= w - k) break;
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          if (c + q + 1 < kNB)
            acc[c + q] = cfms_conj(acc[c + q + 1], l[c + q], y);
      }
    }
    if (out) {
      for (int r = kend; r < nb; ++r)
        Linv[base + (long long)r * nb + lane] = unit<T>(r == lane);
    }
  }
  // L out by warps 0, 2 and 3 once warp 0 has left it in LL (barrier 1,
  // 96 threads; warp 1 does not wait)
  if (warp != 1) {
    asm volatile("bar.sync 1, 96;" ::: "memory");
    tile_out(Lout + base, LL, nb, vec, warp == 0 ? lane : tid - 32, 96);
  }
}

template <typename T>
int launch(const void* wrel, const void* D, void* L, void* Linv, int B,
           int nb, void* stream) {
  if (nb < 1 || nb > kNB) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const bool vec = nb == kNB && (size_t)L % 16 == 0;
    potrf_inv_c_kernel<T><<<(unsigned)B, kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const int*)wrel, (const Cx<T>*)D, (Cx<T>*)L, (Cx<T>*)Linv, nb, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spfx_potrf_inv_c64(const void* wrel, const void* D, void* L,
                                  void* Linv, int B, int nb, void* stream) {
  return launch<float>(wrel, D, L, Linv, B, nb, stream);
}

extern "C" int spfx_potrf_inv_c128(const void* wrel, const void* D, void* L,
                                   void* Linv, int B, int nb, void* stream) {
  return launch<double>(wrel, D, L, Linv, B, nb, stream);
}
