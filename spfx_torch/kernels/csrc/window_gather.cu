// Batched superwindow gather from the flat factor, for sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py dma_gather2 (two window sets in
// one launch) and dma_gather (one set): on the TPU each window is one DMA
// descriptor, ``ns`` of them in flight from a sequential grid.
//
// What it computes: for window b of set X (X = a, b),
//   out_X[b, :] = L[al(s) : al(s) + win_X],  al(s) = (s / 1024) * 1024,
// where s = starts_X[b] >= 0; a window with s < 0 is a dead task and its
// row of out_X is written with zeros (the same bytes the CPU gather with
// FILL_OR_DROP produces). Starts are aligned down to 1024 ELEMENTS whatever
// the element type: the plan builds its row masks, column maps and
// extend-add tables against that superwindow base. No clipping: a live
// window that would end past the flat array is a plan error and traps.
//
// What bounds it on the H100: memory. It moves
//   (live windows * win  read  +  all windows * win  written) * itemsize
// bytes and computes nothing, so its floor is that over 3.35 TB/s.
//
// What the design does about it: one thread block per window (the grid
// covers Ba + Bb windows, so both sets go in one launch), neighbouring
// threads on neighbouring addresses. Every source window starts on a
// 1024-element boundary; a window is any positive number of elements (an
// update step's source superwindow is (mp + 1024/kp) kp elements, 1,280
// or 1,536 under small tiles or classes). Where win is a whole number of
// 16-byte vectors, each output row starts on a 16-byte boundary too and
// the threads move uint4 vectors; otherwise rows do not stay aligned and
// the block moves single elements (4 or 8 bytes). The choice is made
// per block, so each set of a launch takes its own. Offsets are computed
// in 64 bits. There is no shared memory and no reuse: every byte is read
// once and written once.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr long long kAlign = 1024;   // elements, as the plan's ALIGN

// n units of type U from src to dst (src null: zeros), by the block
template <typename U>
__device__ __forceinline__ void copy_units(const void* src, void* dst,
                                           long long n) {
  U* d = (U*)dst;
  if (src == nullptr) {
    const U z{};
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = z;
    return;
  }
  const U* s = (const U*)src;
#pragma unroll 4
  for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__global__ void window_gather_kernel(const char* __restrict__ L,
                                     long long n_elems, int elem_bytes,
                                     const int* __restrict__ starts_a,
                                     int Ba, long long win_a,
                                     char* __restrict__ out_a,
                                     const int* __restrict__ starts_b,
                                     long long win_b,
                                     char* __restrict__ out_b) {
  const long long w = blockIdx.x;
  const bool in_a = w < Ba;
  const long long j = in_a ? w : w - Ba;
  const long long win = in_a ? win_a : win_b;
  const long long s = in_a ? starts_a[j] : starts_b[j];
  const long long bytes = win * elem_bytes;
  char* dst = (in_a ? out_a : out_b) + j * bytes;
  const char* src = nullptr;          // a dead window: zeros
  if (s >= 0) {
    const long long al = (s / kAlign) * kAlign;
    if (al + win > n_elems) {
      if (threadIdx.x == 0)
        printf("window_gather: window %lld (start %lld, aligned %lld, "
               "len %lld) ends past the flat array (%lld elements)\n",
               w, s, al, win, n_elems);
      __trap();
    }
    src = L + al * elem_bytes;
  }
  if (bytes % 16 == 0) copy_units<uint4>(src, dst, bytes / 16);
  else if (elem_bytes == 8) copy_units<uint2>(src, dst, win);
  else copy_units<unsigned>(src, dst, win);   // 16-byte elements: vectors
}

}  // namespace

// Both window sets in one launch. Either set may be empty (B = 0); with no
// window at all nothing is launched. Returns cudaGetLastError().
extern "C" int spfx_window_gather2(const void* L, long long n_elems,
                                   int elem_bytes, const void* starts_a,
                                   int Ba, long long win_a, void* out_a,
                                   const void* starts_b, int Bb,
                                   long long win_b, void* out_b,
                                   void* stream) {
  const long long total = (long long)Ba + (long long)Bb;
  if (total > 0) {
    window_gather_kernel<<<(unsigned)total, 256, 0, (cudaStream_t)stream>>>(
        (const char*)L, n_elems, elem_bytes, (const int*)starts_a, Ba,
        win_a, (char*)out_a, (const int*)starts_b, win_b, (char*)out_b);
  }
  return (int)cudaGetLastError();
}
