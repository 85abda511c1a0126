// Batched float32 matrix product in three bf16 passes ("bf16x3"), for
// sm_90a.
//
// What it computes: C[b] = A[b] B[b] for A (batch, m, k) and B (batch, k, n)
// float32 at any strides (the transposed views the blocked panel and the
// update steps pass in), C (batch, m, n) contiguous float32. Each operand
// value x is split where it is loaded into hi = bf16_rn(x) and
// lo = bf16_rn(x - hi), and the product is hi.hi + hi.lo + lo.hi summed in
// float32: JAX's matmul precision "high" (spfx/utils/config.py, used around
// the update products at spfx/kernels/mega.py), which XLA computes the same
// way on the TPU's matrix unit. Its error is about 2^-16 of sum |a||b| per
// entry (the dropped lo.lo term and the rounding of lo), against 2^-8 for
// one bf16 pass and about 2^-24 k for full float32. No Pallas kernel
// computes it: on the TPU it is XLA's dot under that precision.
//
// What bounds it on the H100: operations or bytes by shape. It does
// 3 x 2 m n k bf16 tensor-core operations (989 TFLOP/s dense, the H100 SXM
// data sheet) and moves (m k + k n + m n) x 4 bytes per batch item.
//
// What the design does about it: a simple tiled kernel, right first. One
// thread block of four warps per 64 x 64 tile of one C[b] (grid: batch,
// row tiles, column tiles); 32-deep slices of A and B are loaded from
// device memory with the caller's strides (consecutive threads on the
// operand's unit-stride dimension where it has one), split, and stored to
// shared memory as four bf16 tiles (A hi/lo row-major, B hi/lo column-major,
// rows padded to 40 values); each warp owns a 32 x 32 part of the tile and
// issues mma.sync m16n8k16 (bf16 in, float32 accumulators) three times per
// fragment pair. Ragged edges load zeros. No double buffering, no TMA, no
// wgmma: a later PR's work if the products show up in a trace.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kPad = 40;           // bf16 values per shared row (kBK + 8)
constexpr int kThreads = 128;

__device__ __forceinline__ void split(float x, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
bmm_bf16x3_kernel(const float* __restrict__ A, long long sab, long long sam,
                  long long sak, const float* __restrict__ B, long long sbb,
                  long long sbk, long long sbn, float* __restrict__ C, int m,
                  int n, int k) {
  __shared__ __nv_bfloat16 Ahi[kBM][kPad], Alo[kBM][kPad];
  __shared__ __nv_bfloat16 Bhi[kBN][kPad], Blo[kBN][kPad];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long bat = blockIdx.x;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.z * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const float* Ab = A + bat * sab;
  const float* Bb = B + bat * sbb;
  const bool a_kfast = sak == 1, b_kfast = sbk == 1 || sbn != 1;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A slice (kBM x kBK) and B slice (kBK x kBN), kBM * kBK / kThreads = 16
    // values a thread each
#pragma unroll 4
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int i = a_kfast ? e / kBK : e % kBM;
      const int kk = a_kfast ? e % kBK : e / kBM;
      const int gi = row0 + i, gk = k0 + kk;
      const float x = (gi < m && gk < k) ? Ab[gi * sam + gk * sak] : 0.f;
      split(x, Ahi[i][kk], Alo[i][kk]);
    }
#pragma unroll 4
    for (int r = 0; r < kBN * kBK / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int j = b_kfast ? e / kBK : e % kBN;
      const int kk = b_kfast ? e % kBK : e / kBN;
      const int gj = col0 + j, gk = k0 + kk;
      const float x = (gj < n && gk < k) ? Bb[gk * sbk + gj * sbn] : 0.f;
      split(x, Bhi[j][kk], Blo[j][kk]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        const int c = ks + t * 2;
        ah[mi][0] = ld32(&Ahi[r][c]);
        ah[mi][1] = ld32(&Ahi[r + 8][c]);
        ah[mi][2] = ld32(&Ahi[r][c + 8]);
        ah[mi][3] = ld32(&Ahi[r + 8][c + 8]);
        al[mi][0] = ld32(&Alo[r][c]);
        al[mi][1] = ld32(&Alo[r + 8][c]);
        al[mi][2] = ld32(&Alo[r][c + 8]);
        al[mi][3] = ld32(&Alo[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int j = wn + ni * 8 + g;
        const int c = ks + t * 2;
        bh[ni][0] = ld32(&Bhi[j][c]);
        bh[ni][1] = ld32(&Bhi[j][c + 8]);
        bl[ni][0] = ld32(&Blo[j][c]);
        bl[ni][1] = ld32(&Blo[j][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma(acc[mi][ni], al[mi], bh[ni]);
          mma(acc[mi][ni], ah[mi], bl[ni]);
          mma(acc[mi][ni], ah[mi], bh[ni]);
        }
    }
    __syncthreads();
  }
  float* Cb = C + bat * (long long)m * n;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + mi * 16 + g + h * 8;
        const int c = col0 + wn + ni * 8 + t * 2;
        if (r < m) {
          if (c < n) Cb[(long long)r * n + c] = acc[mi][ni][2 * h];
          if (c + 1 < n) Cb[(long long)r * n + c + 1] = acc[mi][ni][2 * h + 1];
        }
      }
}

}  // namespace

// C = A B per batch item; strides in elements. Nothing is launched when
// batch, m or n is 0. Returns cudaGetLastError().
extern "C" int spfx_bmm_bf16x3_f32(const void* A, long long sab,
                                   long long sam, long long sak,
                                   const void* B, long long sbb,
                                   long long sbk, long long sbn, void* C,
                                   int batch, int m, int n, int k,
                                   void* stream) {
  if (batch < 0 || m < 0 || n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (batch > 0 && m > 0 && n > 0) {
    const dim3 grid((unsigned)batch, (unsigned)((m + kBM - 1) / kBM),
                    (unsigned)((n + kBN - 1) / kBN));
    if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
    bmm_bf16x3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)A, sab, sam, sak, (const float*)B, sbb, sbk, sbn,
        (float*)C, m, n, k);
  }
  return (int)cudaGetLastError();
}
