// Batched Cholesky of small SPD matrices, for sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py cholesky_small_batched (body
// _chol_lanes_kernel): on the TPU a slab of matrices sits in VMEM and the
// column recurrence runs across the slab at once, column j pulled out with
// a one-hot contraction.
//
// What it computes, per matrix b of D (batch, c, c), c <= 32, row-major:
// the lower Cholesky factor L of the SPD matrix whose lower triangle is
// D[b]'s (the upper triangle is never read into the result), with exact
// zeros above the diagonal. The recurrence is the TPU kernel's: column j
// is scaled by p_j = rsqrt(d_jj) (the diagonal included), then the
// trailing lower triangle takes the rank-1 update. A non-positive pivot
// gives NaN, as rsqrt does on the TPU; nothing is checked.
//
// What bounds it on the H100: memory. Per matrix it reads the c(c+1)/2
// values of the lower triangle and writes c^2 for c^3/3 flops (under 2
// flop a byte in f32 at c = 32), so the floor is those bytes over
// 3.35 TB/s: 0.1214 ms at (65,536, 32) f32. Timed in parts
// (spfx_torch/bench/kernel_probe.py chol_small) on the NVIDIA H100 80GB
// HBM3 at 700 W, the one-warp-a-matrix design this replaces took
// 0.357 ms there: its staging and stores alone 0.266 (a row load, then a
// row store, per dependent round trip, and nothing overlapped the next
// matrix), its chain of 528 shuffles a matrix alone 0.204 (twice that in
// f64, where a shuffle moves half a value).
//
// What the design does about it:
//  - Persistent warps: the grid is the SMs times the blocks of four warps
//    that fit on one, and warp w takes matrices w, w + W, ... (W warps in
//    all). Each warp owns a ring of two 32 x S tiles in shared memory,
//    S = 32 + one 16-byte vector: rows stay 16-byte aligned, and eight
//    lanes' 16-byte row accesses fall in eight different bank groups.
//  - The next matrix is requested (cp.async, straight into the other
//    tile) before the current one is factored: every chunk that holds an
//    entry on or below the diagonal, 16 bytes at a time with the warp on
//    512 contiguous bytes where rows are 16-byte aligned (c * sizeof(T) a
//    multiple of 16, D and L aligned: 576 of the 1,024 values at c = 32
//    f32), single values on the warp's contiguous span otherwise.
//  - Lane i holds row i in registers. At step j every lane writes its
//    column-j entry to one of two alternating rows of shared memory and,
//    after a warp barrier, reads the row back as broadcast 16-byte reads;
//    then L_ij = a_ij p_j and a_ik -= (L_ij p_j) a_kj for k > j, one FMA
//    an entry. Every lane runs every update: a lane's entries above its
//    diagonal take junk (NaN and Inf included) but never feed an entry on
//    or below one, so no predicate is needed. Steps past c change nothing
//    a result holds, and the loop stops at the first multiple of 8 at or
//    past c. For c <= 16 the rows are 16 wide and a warp takes two
//    matrices at a time, one in each half of its lanes and tiles: a
//    32-wide row would spend most of its updates on padding.
//  - The factor, its upper triangle selected to zero, goes back into the
//    tile it came from, row by row, and out as coalesced 16-byte (or
//    single-value) stores that nothing waits for.
// Measured on the card and not kept (kernel_probe with variant sources,
// f32 at (65,536, 32), where this design takes 0.182-0.188 ms): the
// column by shuffles (0.196; f64 0.421 against 0.330), the whole matrix
// loaded (0.204), each lane storing its own row straight from registers
// (0.349), a third tile to request two matrices ahead (0.190, four
// blocks an SM; f64 3% faster), four or six blocks an SM (0.188, 0.192),
// every column step run (0.191).
// Templated on float and double, the 16-byte path and the row width.

#include <cuda_runtime.h>

#include "diag_block.cuh"

namespace {

using namespace diag_block;

constexpr int kC = kNB;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here.
constexpr bool kStage = true, kFactor = true, kStore = true, kBody = true;
constexpr bool kStopAtC = true;

template <typename T>
struct Tile {
  static constexpr int V = Vec<T>::n;           // values in 16 bytes
  static constexpr int S = kC + V;              // row stride
  static constexpr int kSlot = kC * S;          // one tile
  static constexpr int kWarp = 2 * kSlot + 2 * kC;  // ring + column rows
  static constexpr size_t kBytes = (size_t)kWarps * kWarp * sizeof(T);
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 5 : 3;
};

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(__cvta_generic_to_global(src))
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(__cvta_generic_to_global(src)), "n"(kBytes)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A matrix's units, in order: 16-byte chunks (kVec, n = c / V a row) or
// single values (n = c a row); unit g sits in row g / n, which is
// (g * div) >> 16 with div = ceil(2^16 / n), exact for g < 2^16 / 32.
template <typename T, bool kVec>
struct Units {
  int n, total;
  unsigned div;
  __device__ explicit Units(int c) {
    n = kVec ? c / Tile<T>::V : c;
    total = c * n;
    div = (65536u + n - 1) / n;
  }
  // unit g: its row r and its first column k
  __device__ __forceinline__ void at(int g, int& r, int& k) const {
    r = (int)((g * div) >> 16);
    k = (g - r * n) * (kVec ? Tile<T>::V : 1);
  }
};

// request every unit of src (one c x c matrix) that holds an entry on or
// below the diagonal, into tile
template <typename T, bool kVec>
__device__ __forceinline__ void stage(T* tile, const T* src,
                                      const Units<T, kVec>& u, int lane) {
  constexpr int V = kVec ? Tile<T>::V : 1;
  for (int g = lane; g < u.total; g += 32) {
    int r, k;
    u.at(g, r, k);
    if (k <= r)
      cp_async<V * sizeof(T)>(tile + r * Tile<T>::S + k, src + g * V);
  }
}

// dst (one c x c matrix) = the leading c x c part of tile
template <typename T, bool kVec>
__device__ __forceinline__ void store(T* dst, const T* tile,
                                      const Units<T, kVec>& u, int lane) {
  using VT = typename Vec<T>::type;
  for (int g = lane; g < u.total; g += 32) {
    int r, k;
    u.at(g, r, k);
    if (kVec)
      ((VT*)dst)[g] = *(const VT*)(tile + r * Tile<T>::S + k);
    else
      dst[g] = tile[r * Tile<T>::S + k];
  }
}

// right-looking column Cholesky of a kW-wide matrix, lane i holding its
// row r = i % kW, column j passed through one of two alternating rows of
// shared memory (the matrix's kW values of it from lane i - r on)
template <typename T, int kW>
__device__ __forceinline__ void factor(T (&a)[kW], T* colrows, int c,
                                       int lane) {
  const int first = lane - lane % kW;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (kStopAtC && j % 8 == 0 && j >= c) break;
    T* row = colrows + (j & 1) * kC;
    row[lane] = a[j];                            // column j, unscaled
    __syncwarp();
    T col[kW];
    ld_from<T, kW>(row + first, j, col);
    const T piv = rsqrt_t(col[j]);
    const T l = a[j] * piv;                      // L[r][j]
    const T s = l * piv;
    a[j] = l;
#pragma unroll
    for (int k = j + 1; k < kW; ++k) a[k] -= s * col[k];
  }
}

// kW: 32, or 16 for c <= 16; a warp then takes G = 32 / kW matrices at a
// time, one in each kW rows of its tiles (lanes and rows g kW .. g kW +
// kW - 1 hold matrix g)
template <typename T, bool kVec, int kW>
__global__ void __launch_bounds__(kThreads, Tile<T>::kMinBlocks)
chol_small_kernel(const T* __restrict__ D, T* __restrict__ Lout, int batch,
                  int c) {
  using TL = Tile<T>;
  constexpr int G = kC / kW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane % kW;
  T* ring = (T*)smem + warp * TL::kWarp;
  T* colrows = ring + 2 * TL::kSlot;
  const int W = gridDim.x * kWarps * G;
  int m = (blockIdx.x * kWarps + warp) * G;     // the warp's first matrix
  if (!kBody || m >= batch) return;   // the whole warp: no block barrier
  const long long cc = (long long)c * c;
  const Units<T, kVec> u(c);

  for (int g = 0; g < G && kStage && m + g < batch; ++g)
    stage(ring + g * kW * TL::S, D + (m + g) * cc, u, lane);
  cp_commit();
  for (int it = 0; m < batch; m += W, ++it) {
    T* cur = ring + (it & 1) * TL::kSlot;
    cp_wait_all();
    __syncwarp();
    T a[kW];
    if (kStage) {
      ld_from<T, kW>(cur + lane * TL::S, 0, a);
    } else {
#pragma unroll
      for (int k = 0; k < kW; ++k)
        a[k] = k == r ? T(2 * kW + (m & 1)) : T(1);
    }
    // the next matrices stream into the other tile meanwhile
    T* nxt = ring + (~it & 1) * TL::kSlot;
    for (int g = 0; g < G && kStage && m + W + g < batch; ++g)
      stage(nxt + g * kW * TL::S, D + (m + W + g) * cc, u, lane);
    cp_commit();
    if (kFactor) factor(a, colrows, c, lane);
#pragma unroll
    for (int k = 0; k < kW; ++k) a[k] = k <= r ? a[k] : T(0);
    if (!kStore) {                  // one value a lane keeps the rest live
      T v = T(0);
#pragma unroll
      for (int k = 0; k < kW; ++k) v += a[k];
      if (r < cc && m + lane / kW < batch)
        Lout[(m + lane / kW) * cc + r] = v;
      continue;
    }
    __syncwarp();
    st_row<T, kW>(cur + lane * TL::S, a);
    __syncwarp();
    for (int g = 0; g < G && m + g < batch; ++g)
      store(Lout + (m + g) * cc, cur + g * kW * TL::S, u, lane);
  }
}

// the persistent grid: the SMs times the blocks that fit on one (found
// once per kernel), and no more blocks than the batch fills
template <typename T, bool kVec, int kW>
int launch_t(const T* D, T* L, int batch, int c, cudaStream_t stream) {
  static int fit = 0, sms = 0;
  const auto kern = chol_small_kernel<T, kVec, kW>;
  constexpr size_t smem = Tile<T>::kBytes;
  if (fit == 0) {
    int dev = 0, n = 0, f = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (!e)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (!e)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (!e)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kern, kThreads,
                                                        smem);
    if (e) return (int)e;
    if (f < 1) return (int)cudaErrorInvalidConfiguration;
    fit = f;
    sms = n;
  }
  constexpr int per = kWarps * kC / kW;        // matrices a block at a time
  const long long need = ((long long)batch + per - 1) / per;
  const long long cap = (long long)fit * sms;
  chol_small_kernel<T, kVec, kW>
      <<<(unsigned)(need < cap ? need : cap), kThreads, smem, stream>>>(
          D, L, batch, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* D, void* L, int batch, int c, void* stream) {
  if (batch < 0 || c < 1 || c > kC) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaGetLastError();
  const bool vec = (c * sizeof(T)) % 16 == 0 && (size_t)D % 16 == 0 &&
                   (size_t)L % 16 == 0;
  const T* d = (const T*)D;
  T* l = (T*)L;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c <= 16)
    return vec ? launch_t<T, true, 16>(d, l, batch, c, s)
               : launch_t<T, false, 16>(d, l, batch, c, s);
  return vec ? launch_t<T, true, kC>(d, l, batch, c, s)
             : launch_t<T, false, kC>(d, l, batch, c, s);
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
