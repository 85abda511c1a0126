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
// outputs are two thirds of the bytes.
//
// What the design does about it: one thread block per batch item, which
// walks C in tiles of 128 rows by 64 columns (one tile at the bench's
// shape). For each tile, the k dimension goes through shared memory in
// chunks of 16: the tile's 128 rows of [A; B] are staged k-major, and the
// 64 rows of A that give its columns are read from that same staged block
// when they lie inside it (always at the bench's shape), so A is loaded
// once for both products, as in the fused TPU kernel; otherwise they are
// staged beside it. Each of the 256 threads keeps an 8 x 4 register tile of
// C (rows ty + 16 i, columns tx + 16 j), so a step of k costs 12
// shared-memory reads for 32 fused multiply-adds, and the writes of a warp
// cover 16 neighbouring columns of two rows. Ragged edges are zero-filled
// on the way in and masked on the way out, so any n, m, k >= 1 works.
// Templated on float and double; float products are full float32.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 128;            // rows of C per tile
constexpr int kTN = 64;             // columns of C per tile
constexpr int kKC = 16;             // k per staged chunk
constexpr int kLd = kTM + 1;        // padded leading dimension of the tiles
constexpr int kThreads = 256;       // 16 x 16
constexpr int kRI = kTM / 16;       // register tile rows
constexpr int kRJ = kTN / 16;       // register tile columns

template <typename T>
__global__ void __launch_bounds__(kThreads)
syrk_gemm_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
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

template <typename T>
int launch(const void* A, const void* B, void* S, void* G, int batch, int n,
           int m, int k, void* stream) {
  if (batch < 0 || n < 1 || m < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    syrk_gemm_kernel<T><<<(unsigned)batch, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const T*)A, (const T*)B, (T*)S, (T*)G, n, m, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// S (batch, n, n) = A A^T and G (batch, m, n) = B A^T for A (batch, n, k),
// B (batch, m, k); with batch == 0 nothing is launched. Returns
// cudaGetLastError().
extern "C" int spfx_syrk_gemm_batched_f32(const void* A, const void* B,
                                          void* S, void* G, int batch, int n,
                                          int m, int k, void* stream) {
  return launch<float>(A, B, S, G, batch, n, m, k, stream);
}

extern "C" int spfx_syrk_gemm_batched_f64(const void* A, const void* B,
                                          void* S, void* G, int batch, int n,
                                          int m, int k, void* stream) {
  return launch<double>(A, B, S, G, batch, n, m, k, stream);
}
