// Fused batched SYRK + GEMM of small panels, for sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py syrk_gemm_batched: on the TPU a
// grid step holds a slab of tasks in VMEM and runs both products on the
// MXU, A's tile loaded once for both.
//
// What it computes, per batch item b, with A (batch, n, k) and
// B (batch, m, k) row-major:
//   S[b] = A[b] A[b]^T   (n, n)      G[b] = B[b] A[b]^T   (m, n).
// Both are one product, C = [A[b]; B[b]] A[b]^T of (n + m, n): rows < n of
// C are S, the others G.
//
// What bounds it on the H100: at the panel bench's shape (n = m = 64,
// k = 32, f32) memory. Each item reads (n + m) k values and writes
// (n + m) n, 2 (n + m) n k flops: about 11 flop a byte in f32, under the
// 20 of the card's non-tensor f32 ridge (67 TFLOP/s over 3.35 TB/s); the
// outputs are two thirds of the bytes. The products are still half the
// byte time, so they can hide only behind the loads and stores of other
// items.
//
// Two paths, chosen by the wrapper (syrk_gemm.path) from the shape and the
// alignment:
//
// The bulk path (n <= 64, n + m <= 128, k <= 32, n and k multiples of a
// 16-byte vector, A and B 16-byte aligned; the bench's shape) streams the
// batch through persistent thread blocks, a few on each SM, each walking
// items b = blockIdx.x + i gridDim.x. An item's A[b] and B[b] are two
// contiguous runs, together [A; B] row-major; each comes into a ring of
// stages in shared memory by one 1-D bulk copy (cp.async.bulk, global to
// shared, completing on the stage's mbarrier), issued kStages items ahead,
// so the loads of the next items are in flight while one item is formed.
// The block transposes the arrived item into a k-major tile (rows read as
// 16-byte vectors, each lane's k order rotated by its row so that neither
// the reads nor the column writes share a bank), then each of the 256
// threads forms an 8 x 4 block of C = [A; B] A^T: per step of k, three
// 16-byte shared-memory reads (its 8 rows, its 4 columns; half the warp
// shares each row vector) for 32 fused multiply-adds. A thread's 4 columns
// are contiguous, so S and G leave as 16-byte stores straight from the
// registers, a warp writing whole 256-byte row segments.
//
// The general path takes every other shape: one thread block per batch
// item, which walks C in tiles of 128 rows by 64 columns. For each tile,
// the k dimension goes through shared memory in chunks of 16: the tile's
// 128 rows of [A; B] are staged k-major, and the 64 rows of A that give
// its columns are read from that same staged block when they lie inside
// it, so A is loaded once for both products; otherwise they are staged
// beside it. Each of the 256 threads keeps an 8 x 4 register tile of C
// (rows ty + 16 i, columns tx + 16 j). Ragged edges are zero-filled on the
// way in and masked on the way out, so any n, m, k >= 1 works.
//
// Both are templated on float and double; float products are full float32
// fused multiply-adds, no TF32.

#include <cuda_runtime.h>

#include <cstdint>

#include "vec16.cuh"

namespace {

// ---------------------------------------------------------------- general

constexpr int kTM = 128;            // rows of C per tile
constexpr int kTN = 64;             // columns of C per tile
constexpr int kKC = 16;             // k per staged chunk
constexpr int kLd = kTM + 1;        // padded leading dimension of the tiles
constexpr int kThreads = 256;       // 16 x 16
constexpr int kRI = kTM / 16;       // register tile rows
constexpr int kRJ = kTN / 16;       // register tile columns

template <typename T>
__global__ void __launch_bounds__(kThreads)
syrk_gemm_general(const T* __restrict__ A, const T* __restrict__ Bm,
                  T* __restrict__ S, T* __restrict__ G, int n, int m, int k) {
  __shared__ T Xs[kKC][kLd];        // rows of [A; B], k-major
  __shared__ T As[kKC][kLd];        // rows of A for the columns, k-major
  const long long b = blockIdx.x;
  const T* Ab = A + b * n * (long long)k;
  const T* Bb = Bm + b * m * (long long)k;
  T* Sb = S + b * n * (long long)n;
  T* Gb = G + b * m * (long long)n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rows = n + m;

  for (int r0 = 0; r0 < rows; r0 += kTM) {
    for (int c0 = 0; c0 < n; c0 += kTN) {
      // the column rows [c0, c0 + kTN) inside the staged row block: read
      // them there (columns >= n are never written, so B rows standing in
      // for them are harmless)
      const bool reuse = c0 >= r0 && c0 + kTN <= r0 + kTM;
      const T(*Cs)[kLd] = reuse ? Xs : As;
      const int coff = reuse ? c0 - r0 : 0;
      T acc[kRI][kRJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kRJ; ++j) acc[i][j] = T(0);

      for (int k0 = 0; k0 < k; k0 += kKC) {
        __syncthreads();            // the previous chunk is consumed
        for (int e = threadIdx.x; e < kTM * kKC; e += kThreads) {
          const int r = e / kKC, kk = e % kKC;
          const int gr = r0 + r, gk = k0 + kk;
          T v = T(0);
          if (gk < k) {
            if (gr < n)
              v = Ab[(long long)gr * k + gk];
            else if (gr < rows)
              v = Bb[(long long)(gr - n) * k + gk];
          }
          Xs[kk][r] = v;
        }
        if (!reuse) {
          for (int e = threadIdx.x; e < kTN * kKC; e += kThreads) {
            const int r = e / kKC, kk = e % kKC;
            const int gr = c0 + r, gk = k0 + kk;
            As[kk][r] = (gr < n && gk < k) ? Ab[(long long)gr * k + gk]
                                           : T(0);
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKC; ++kk) {
          T x[kRI], y[kRJ];
#pragma unroll
          for (int i = 0; i < kRI; ++i) x[i] = Xs[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kRJ; ++j) y[j] = Cs[kk][coff + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRI; ++i)
#pragma unroll
            for (int j = 0; j < kRJ; ++j) acc[i][j] += x[i] * y[j];
        }
      }

#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const int gr = r0 + ty + 16 * i;
        if (gr >= rows) continue;
        T* out = gr < n ? Sb + (long long)gr * n : Gb + (long long)(gr - n) * n;
#pragma unroll
        for (int j = 0; j < kRJ; ++j) {
          const int gc = c0 + tx + 16 * j;
          if (gc < n) out[gc] = acc[i][j];
        }
      }
    }
  }
}

// ------------------------------------------------------------------- bulk

constexpr int kBRows = 128;         // rows of C = [A; B] A^T it covers
constexpr int kBCols = 64;          // columns of C
constexpr int kBK = 32;             // largest k
constexpr int kBThreads = 256;      // 16 row groups x 16 column groups
constexpr int kTR = 8, kTC = 4;     // a thread's rows and columns of C
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here. Without stores, a test that never
// holds keeps the products alive.
constexpr bool kLoads = true, kProducts = true, kStores = true;

// the ring's depth and the k-major tile's padded row, by type: f32 fits
// three blocks of three stages on an SM, f64 two of two
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 4 ? 3 : 2; }
template <typename T>
__host__ __device__ constexpr int tile_ld() { return kBRows + Vec<T>::n; }
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kBRows * kBK * (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int bulk_smem() {
  return stages<T>() * stage_bytes<T>() + kBK * tile_ld<T>() * (int)sizeof(T)
         + stages<T>() * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// item b's [A; B] into the stage at ``dst``, completing on ``bar``
template <typename T>
__device__ __forceinline__ void load_item(uint32_t dst, uint32_t bar,
                                          const T* A, const T* Bm,
                                          long long b, int n, int m, int k) {
  if (!kLoads) return;
  const uint32_t na = (uint32_t)(n * k * sizeof(T));
  const uint32_t nb = (uint32_t)(m * k * sizeof(T));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(na + nb) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(A + b * n * (long long)k), "r"(na), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst + na), "l"(Bm + b * m * (long long)k), "r"(nb), "r"(bar)
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kBThreads, 2)
syrk_gemm_bulk(const T* __restrict__ A, const T* __restrict__ Bm,
               T* __restrict__ S, T* __restrict__ G, long long batch, int n,
               int m, int k) {
  using V = Vec<T>;
  constexpr int kS = stages<T>(), kLdt = tile_ld<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Xt = (T*)(smem + kS * stage_bytes<T>());          // [kBK][kLdt]
  uint64_t* full = (uint64_t*)(smem + kS * stage_bytes<T>()
                               + kBK * kLdt * sizeof(T));
  const int tid = threadIdx.x;
  const int rows = n + m, kv = k / V::n;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kS; ++s) {
      const long long b = blockIdx.x + (long long)s * gridDim.x;
      if (b < batch)
        load_item<T>(smem_addr(smem + s * stage_bytes<T>()),
                     smem_addr(full + s), A, Bm, b, n, m, k);
    }
  }
  __syncthreads();

  // this thread's block of C: rows rg*8 + [0, 8), columns cg*4 + [0, 4);
  // the two halves of a warp share their columns, each half its rows
  const int warp = tid / 32, lane = tid % 32;
  const int rg = 2 * warp + lane / 16, cg = lane % 16;
  const int r0 = rg * kTR, c0 = cg * kTC;
  // this thread's row of the transpose, its first vector slot, its rotation
  const int tr = tid % kBRows, ts = tid / kBRows, rot = tr % kv;

  int it = 0;
  for (long long b = blockIdx.x; b < batch; b += gridDim.x, ++it) {
    const int s = it % kS;
    const unsigned char* st = smem + s * stage_bytes<T>();
    while (kLoads && !mbar_done(smem_addr(full + s), (it / kS) & 1)) {
    }
    // k-major tile: Xt[kk][r] = X[r][kk]; row tr's vectors are read in
    // the rotated order (slot + tr) mod kv, so a quarter warp (eight rows)
    // reads eight different bank groups and the column writes of a warp
    // fall in different banks
    if (tr < rows) {
      for (int slot = ts; slot < kv; slot += kBThreads / kBRows) {
        int q = slot + rot;
        if (q >= kv) q -= kv;
        T v[V::n];
        if (kLoads) {
          V::get(((const typename V::type*)st)[tr * kv + q], v);
        } else {
#pragma unroll
          for (int u = 0; u < V::n; ++u) v[u] = T(tr + u);
        }
#pragma unroll
        for (int u = 0; u < V::n; ++u) Xt[(q * V::n + u) * kLdt + tr] = v[u];
      }
    }
    __syncthreads();                // the tile is whole; the stage is free
    if (tid == 0) {
      const long long nb = b + (long long)kS * gridDim.x;
      if (nb < batch)
        load_item<T>(smem_addr(st), smem_addr(full + s), A, Bm, nb, n, m, k);
    }

    T acc[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = T(0);
    if (kProducts) {
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk) {
        const typename V::type* xr =
            (const typename V::type*)(Xt + kk * kLdt + r0);
        const typename V::type* xc =
            (const typename V::type*)(Xt + kk * kLdt + c0);
        T x[kTR], y[kTC];
#pragma unroll
        for (int q = 0; q < kTR / V::n; ++q) V::get(xr[q], x + q * V::n);
#pragma unroll
        for (int q = 0; q < kTC / V::n; ++q) V::get(xc[q], y + q * V::n);
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j) acc[i][j] += x[i] * y[j];
      }
    }
    __syncthreads();                // the tile is read; the next may come

#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = r0 + i;
      if (r >= rows) break;
      T* out = r < n ? S + (b * n + r) * (long long)n
                     : G + (b * m + (r - n)) * (long long)n;
#pragma unroll
      for (int q = 0; q < kTC / V::n; ++q) {
        const int c = c0 + q * V::n;
        if (c < n && (kStores || acc[i][q * V::n] == T(-1e30)))
          *(typename V::type*)(out + c) = V::make(acc[i] + q * V::n);
      }
    }
  }
}

template <typename T>
int launch_general(const void* A, const void* B, void* S, void* G, int batch,
                   int n, int m, int k, void* stream) {
  if (batch < 0 || n < 1 || m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    syrk_gemm_general<T><<<(unsigned)batch, kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const T*)A, (const T*)B, (T*)S, (T*)G, n, m, k);
  }
  return (int)cudaGetLastError();
}

// the bulk path's grid: as many thread blocks as fit on the card at once
// (asked once, before any capture into a graph), at most one per item
template <typename T>
int bulk_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(syrk_gemm_bulk<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bulk_smem<T>());
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, syrk_gemm_bulk<T>, kBThreads, bulk_smem<T>());
    blocks = sms * per_sm;
  }
  return blocks;
}

template <typename T>
int launch_bulk(const void* A, const void* B, void* S, void* G, int batch,
                int n, int m, int k, void* stream) {
  const int vec = 16 / (int)sizeof(T);
  if (batch < 0 || n < 1 || m < 1 || k < 1 || n > kBCols || n + m > kBRows
      || k > kBK || n % vec || k % vec
      || ((uintptr_t)A | (uintptr_t)B | (uintptr_t)S | (uintptr_t)G) % 16)
    return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const int grid = bulk_grid<T>();
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
    syrk_gemm_bulk<T><<<(unsigned)(batch < grid ? batch : grid), kBThreads,
                        bulk_smem<T>(), (cudaStream_t)stream>>>(
        (const T*)A, (const T*)B, (T*)S, (T*)G, batch, n, m, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// S (batch, n, n) = A A^T and G (batch, m, n) = B A^T for A (batch, n, k),
// B (batch, m, k); with batch == 0 nothing is launched. Returns
// cudaGetLastError(). The general path takes any n, m, k >= 1; the bulk
// path returns cudaErrorInvalidValue outside its shapes and alignment.
extern "C" int spfx_syrk_gemm_general_f32(const void* A, const void* B,
                                          void* S, void* G, int batch, int n,
                                          int m, int k, void* stream) {
  return launch_general<float>(A, B, S, G, batch, n, m, k, stream);
}

extern "C" int spfx_syrk_gemm_general_f64(const void* A, const void* B,
                                          void* S, void* G, int batch, int n,
                                          int m, int k, void* stream) {
  return launch_general<double>(A, B, S, G, batch, n, m, k, stream);
}

extern "C" int spfx_syrk_gemm_bulk_f32(const void* A, const void* B, void* S,
                                       void* G, int batch, int n, int m,
                                       int k, void* stream) {
  return launch_bulk<float>(A, B, S, G, batch, n, m, k, stream);
}

extern "C" int spfx_syrk_gemm_bulk_f64(const void* A, const void* B, void* S,
                                       void* G, int batch, int n, int m,
                                       int k, void* stream) {
  return launch_bulk<double>(A, B, S, G, batch, n, m, k, stream);
}
