// Batched float32 matrix product in three bf16 passes ("bf16x3"), for
// sm_90a.
//
// What it computes: C[b] = A[b] B[b] for A (batch, m, k) and B (batch, k, n)
// float32, C (batch, m, n) contiguous float32. Each operand
// value x is split into hi = bf16_rn(x) and lo = bf16_rn(x - hi), and the
// product is hi.hi + hi.lo + lo.hi summed in float32: JAX's matmul
// precision "high" (spfx/utils/config.py, used around the update products
// at spfx/kernels/mega.py), which XLA computes the same way on the TPU's
// matrix unit. Its error is about 2^-16 of sum |a||b| per entry (the
// dropped lo.lo term and the rounding of lo), against 2^-8 for one bf16
// pass and about 2^-24 k for full float32. No Pallas kernel computes it:
// on the TPU it is XLA's dot under that precision.
//
// What bounds it on the H100: operations or bytes by shape. It does
// 3 x 2 m n k bf16 tensor-core operations (989 TFLOP/s dense, the H100 SXM
// data sheet) and moves (m k + k n + m n) x 4 bytes per batch item; at the
// factorization's update products (k <= 256, m <= 160) the bytes bound it.
//
// One kernel, spfx_bmm_bf16x3_fast_f32. It reads both operands
// k-contiguous (A's rows and B's columns unit-stride in k), 16-byte
// aligned, every stride a multiple of 4 values: as the update steps pass
// their products C = G H^T, whose G is a fresh gather and H^T a
// transposed view of a contiguous H. Any other operand (the blocked panel
// path's transposed and offset views, the solves') is first copied once
// into that layout by the caller (spfx_torch/kernels/matmul.py's
// ``fast_layout``): measured on the 48^3 walks' own products under
// matmul_precision "high", the copy and this kernel take 2.3-4.4x less
// time than the earlier kernel that read any strides (a block per 64 x
// 64 tile, scalar loads), which this file no longer holds.
//
// The design, against what the earlier any-strides kernel measured (a
// block per 64 x 64 tile, 1.8x the work at the largest update product;
// loads, split and products in turn with no overlap; 32-bit shared-memory
// reads; scalar stores):
//  - Tiles fitted to the product. A block of eight warps takes a row tile
//    of m rounded up to 16 (a template for each multiple of 16 up to 160)
//    by 32 or 64 columns: the warps split it 2 x 4, each taking half of
//    the 16-row fragments and 8 or 16 of the columns in 8-column
//    fragments; a warp whose columns all lie past n skips its products.
//    So the work is about the tensor cores' grain (matmul.fast_work).
//  - A pipeline: 32-deep stages of A and B arrive by 16-byte cp.async
//    (zero-filled past m, n and k) into a ring of three stages, two in
//    flight while the block multiplies the third; one barrier a stage.
//  - The products by mma.sync m16n8k16 (bf16 in, float32 accumulators).
//    The float32 stage is read straight into the operand fragments with
//    ldmatrix and split into hi and lo in registers (the kernel's note
//    says how k is permuted for it), so no bf16 copy of a stage is
//    written; the three passes lo.hi, hi.lo, hi.hi go into one
//    accumulator, each pass over every column fragment before the next.
//    wgmma is not used: at these shapes the products take about a third
//    of the byte bound's time at mma.sync's rate.
//  - C staged through shared memory and written in 16-byte stores (single
//    values where n is not a multiple of 4).
// Its parts can be switched off (kLoads, kSplit, kProducts, kStores) in
// copies that spfx_torch/bench/kernel_probe.py times.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kFK = 32;          // k values a stage
constexpr int kFS = 36;          // floats a row of a stage (16-byte aligned
                                 // rows, eight rows in eight bank groups)
constexpr int kStages = 3;
constexpr int kFThreads = 256;
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here.
constexpr bool kLoads = true, kSplit = true, kProducts = true,
               kStores = true;

template <int MF, int NF>
constexpr int fast_smem() {
  return kStages * (16 * MF + 32 * NF) * kFS * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two float32 values (x at the lower k) into one bf16x2 of their hi parts
// and one of their lo parts: hi = bf16_rn(x), lo = bf16_rn(x - hi)
__device__ __forceinline__ void split2(uint32_t x, uint32_t y, uint32_t& hi,
                                       uint32_t& lo) {
  const float fx = __uint_as_float(x), fy = __uint_as_float(y);
  const __nv_bfloat162 h = __floats2bfloat162_rn(fx, fy);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(fx - f.x, fy - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One block: rows [row0, row0 + 16 MF) of C[b] by columns [col0, col0 +
// 32 NF), flattened grid (batch, row tiles, column tiles), column tiles
// fastest so that the blocks of one A tile run together. Warp (wm, w)
// takes the 16-row fragments [wm MH, wm MH + MH) and the 8-column
// fragments [w NF, w NF + NF) of the tile. A's rows and B's columns are
// k-contiguous (row stride sam, column stride sbn).
//
// The float32 stage is read straight into the fragments with ldmatrix, a
// 32-bit value being a pair of b16: a thread then holds, of a 16-deep
// half, the values at k = t, 4 + t, 8 + t and 12 + t (t = lane % 4) of its
// rows (and of its B column), where mma.sync's bf16 fragment wants k = 2t,
// 2t + 1, 2t + 8 and 2t + 9. Both operands take that same permutation of
// k, so each product sums the same terms, and the split into hi and lo is
// made in registers.
template <int MF, int NF>
__global__ void __launch_bounds__(kFThreads)
bmm_bf16x3_fast_kernel(const float* __restrict__ A, long long sab,
                       long long sam, const float* __restrict__ B,
                       long long sbb, long long sbn, float* __restrict__ C,
                       int m, int n, int k, int row_tiles, int col_tiles) {
  constexpr int BM = 16 * MF, BN = 32 * NF;
  constexpr int kCS = BN + 8;                 // floats a row of staged C
  constexpr int kPer = ((BM + BN) * (kFK / 4) + kFThreads - 1) / kFThreads;
  constexpr int MH = (MF + 1) / 2;            // row fragments a warp
  static_assert(BM * kCS <= kStages * (BM + BN) * kFS, "C fits the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  float* Fs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int wm = tid >> 7;                    // warps 2 x 4: row half wm
  const int ct = blockIdx.x % col_tiles;
  const int rt = (blockIdx.x / col_tiles) % row_tiles;
  const long long bat = blockIdx.x / ((long long)col_tiles * row_tiles);
  const int row0 = rt * BM, col0 = ct * BN;
  const int rows = min(BM, m - row0), cols = min(BN, n - col0);
  const int rb = (cols + 7) & ~7;             // B rows (columns of C)
  const int chunks = (BM + rb) * (kFK / 4);   // A's BM rows, then B's
  const float* Ab = A + bat * sab + (long long)row0 * sam;
  const float* Bb = B + bat * sbb + (long long)col0 * sbn;
  const int nk = (k + kFK - 1) / kFK;

  // stage s (k0 = s kFK) into ring slot s % kStages: 16-byte copies,
  // zero-filled past m, n and k
  auto load = [&](int s) {
    if (!kLoads) return;
    float* F = Fs + (s % kStages) * (BM + BN) * kFS;
    const int k0 = s * kFK;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * kFThreads;
      if (e >= chunks) break;
      const int r = e >> 3, c = (e & 7) * 4;
      const bool isA = r < BM;
      const int rr = isA ? r : r - BM;
      const int kk = k0 + c;
      const int live = (isA ? rr < rows : rr < cols) ? min(4, k - kk) : 0;
      const float* src = isA ? Ab + (long long)rr * sam + kk
                             : Bb + (long long)rr * sbn + kk;
      cp_async16(F + r * kFS + c, live > 0 ? src : A, live > 0 ? live * 4 : 0);
    }
  };

  float acc[MH][NF][4];
#pragma unroll
  for (int i = 0; i < MH; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][f][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  // a warp whose columns all lie past n has no products
  const bool busy = kProducts && warp * NF * 8 < rb;
  for (int s = 0; s < nk; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();            // stage s landed; slot (s - 1) % kStages free
    if (s + kStages - 1 < nk) load(s + kStages - 1);
    cp_commit();
    if (!busy) continue;
    const float* F = Fs + (s % kStages) * (BM + BN) * kFS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && s * kFK + 16 >= k) break;
      // B fragments of the warp's columns: 8 columns by k 16h + 0-3, 4-7,
      // 8-11, 12-15
      uint32_t bh[NF][2], bl[NF][2];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        uint32_t r[4];
        ldsm_x4(r, F + (BM + (warp * NF + f) * 8 + (lane & 7)) * kFS +
                       h * 16 + (lane >> 3) * 4);
        if (kSplit) {
          split2(r[0], r[1], bh[f][0], bl[f][0]);
          split2(r[2], r[3], bh[f][1], bl[f][1]);
        } else {
          bh[f][0] = bl[f][0] = r[0];
          bh[f][1] = bl[f][1] = r[2];
        }
      }
      // no branch among the fragments, so that the compiler interleaves
      // them: each pass over every column fragment before the next pass,
      // so that no product waits for the one before it
      // with MF odd, the second row half has one fragment fewer
      const bool last = MF % 2 == 0 || wm == 0;
#pragma unroll
      for (int q = 0; q < MH; ++q) {
        if (q == MH - 1 && !last) break;
        const int i = wm * MH + q;
        uint32_t r[8], ah[4], al[4];
        const float* a = F + (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kFS + h * 16 + (lane >> 4) * 4;
        ldsm_x4(r, a);
        ldsm_x4(r + 4, a + 8);
        if (kSplit) {
          split2(r[0], r[2], ah[0], al[0]);
          split2(r[1], r[3], ah[1], al[1]);
          split2(r[4], r[6], ah[2], al[2]);
          split2(r[5], r[7], ah[3], al[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) ah[q] = al[q] = r[2 * q];
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) mma(acc[q][f], al, bh[f]);
#pragma unroll
        for (int f = 0; f < NF; ++f) mma(acc[q][f], ah, bl[f]);
#pragma unroll
        for (int f = 0; f < NF; ++f) mma(acc[q][f], ah, bh[f]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();              // the ring is free for C
  if (!kStores) return;
  float* Cs = Fs;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < MH; ++q) {
    if (wm * MH + q >= MF) break;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int c = (warp * NF + f) * 8 + 2 * t;
      const int r = (wm * MH + q) * 16 + g;
      *reinterpret_cast<float2*>(Cs + r * kCS + c) =
          make_float2(acc[q][f][0], acc[q][f][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * kCS + c) =
          make_float2(acc[q][f][2], acc[q][f][3]);
    }
  }
  __syncthreads();
  float* Cb = C + bat * (long long)m * n + (long long)row0 * n + col0;
  if ((n & 3) == 0) {
    const int q = cols >> 2;
    for (int e = tid; e < rows * q; e += kFThreads) {
      const int r = e / q, c = (e % q) * 4;
      *reinterpret_cast<float4*>(Cb + (long long)r * n + c) =
          *reinterpret_cast<const float4*>(Cs + r * kCS + c);
    }
  } else {
    for (int e = tid; e < rows * cols; e += kFThreads) {
      const int r = e / cols, c = e % cols;
      Cb[(long long)r * n + c] = Cs[r * kCS + c];
    }
  }
}

template <int MF, int NF>
int launch_fast(const float* A, long long sab, long long sam, const float* B,
                long long sbb, long long sbn, float* C, int batch, int m,
                int n, int k, cudaStream_t stream) {
  constexpr int kSmem = fast_smem<MF, NF>();
  // above 48 KB only after the opt-in, set once (before any capture: the
  // callers' first launch is eager)
  static bool opted = false;
  if (!opted && kSmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        bmm_bf16x3_fast_kernel<MF, NF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (rc != cudaSuccess) return (int)rc;
  }
  opted = true;
  const int rt = (m + 16 * MF - 1) / (16 * MF);
  const int ct = (n + 32 * NF - 1) / (32 * NF);
  const long long blocks = (long long)batch * rt * ct;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bmm_bf16x3_fast_kernel<MF, NF><<<(unsigned)blocks, kFThreads, kSmem,
                                   stream>>>(A, sab, sam, B, sbb, sbn, C, m,
                                             n, k, rt, ct);
  return (int)cudaSuccess;
}

template <int NF>
int launch_fast_m(int mf, const float* A, long long sab, long long sam,
                  const float* B, long long sbb, long long sbn, float* C,
                  int batch, int m, int n, int k, cudaStream_t st) {
  switch (mf) {
#define SPFX_FAST_CASE(MF)                                                 \
  case MF:                                                                 \
    return launch_fast<MF, NF>(A, sab, sam, B, sbb, sbn, C, batch, m, n, k, \
                               st);
    SPFX_FAST_CASE(1) SPFX_FAST_CASE(2) SPFX_FAST_CASE(3) SPFX_FAST_CASE(4)
    SPFX_FAST_CASE(5) SPFX_FAST_CASE(6) SPFX_FAST_CASE(7) SPFX_FAST_CASE(8)
    SPFX_FAST_CASE(9) SPFX_FAST_CASE(10)
#undef SPFX_FAST_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C = A B per batch item (see the header): A (batch, m, k) with A[b][i][l] at
// A + b sab + i sam + l, B (batch, k, n) with B[b][l][j] at B + b sbb +
// j sbn + l; every pointer 16-byte aligned and every stride a multiple of
// 4 values (matmul.fast_layout sees to it). tile_m (a multiple of 16 up to 160) and
// tile_n (32 or 64) choose the template (matmul.fast_tile). Nothing is
// launched when batch, m or n is 0. Returns cudaGetLastError().
extern "C" int spfx_bmm_bf16x3_fast_f32(const void* A, long long sab,
                                        long long sam, const void* B,
                                        long long sbb, long long sbn,
                                        void* C, int batch, int m, int n,
                                        int k, int tile_m, int tile_n,
                                        void* stream) {
  if (batch < 0 || m < 0 || n < 0 || k < 0 || tile_m % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || m == 0 || n == 0) return (int)cudaGetLastError();
  const float* a = (const float*)A;
  const float* b = (const float*)B;
  float* c = (float*)C;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if (tile_n == 32)
    rc = launch_fast_m<1>(tile_m / 16, a, sab, sam, b, sbb, sbn, c, batch, m,
                          n, k, st);
  else if (tile_n == 64)
    rc = launch_fast_m<2>(tile_m / 16, a, sab, sam, b, sbb, sbn, c, batch, m,
                          n, k, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}
