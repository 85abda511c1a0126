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
// covers Ba + Bb windows, so both sets go in one launch); every window
// starts on a 1024-element boundary and is a multiple of 1024 elements
// long, so each thread moves 16-byte vectors (uint4) with neighbouring
// threads on neighbouring addresses, and the kernel is the same for f32
// and f64. Offsets are computed in 64 bits. There is no shared memory and
// no reuse: every byte is read once and written once.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr long long kAlign = 1024;   // elements, as the plan's ALIGN

__global__ void window_gather_kernel(const uint4* __restrict__ L,
                                     long long n_elems, int elem_bytes,
                                     const int* __restrict__ starts_a,
                                     int Ba, long long win_a,
                                     uint4* __restrict__ out_a,
                                     const int* __restrict__ starts_b,
                                     long long win_b,
                                     uint4* __restrict__ out_b) {
  const long long w = blockIdx.x;
  const bool in_a = w < Ba;
  const long long j = in_a ? w : w - Ba;
  const long long win = in_a ? win_a : win_b;
  const long long s = in_a ? starts_a[j] : starts_b[j];
  const long long elems_per_vec = 16 / elem_bytes;   // elements per uint4
  const long long nvec = win / elems_per_vec;
  uint4* dst = (in_a ? out_a : out_b) + j * nvec;
  if (s < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x) dst[i] = z;
    return;
  }
  const long long al = (s / kAlign) * kAlign;
  if (al + win > n_elems) {
    if (threadIdx.x == 0)
      printf("window_gather: window %lld (start %lld, aligned %lld, "
             "len %lld) ends past the flat array (%lld elements)\n",
             w, s, al, win, n_elems);
    __trap();
  }
  const uint4* src = L + al / elems_per_vec;
#pragma unroll 4
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x) dst[i] = src[i];
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
        (const uint4*)L, n_elems, elem_bytes, (const int*)starts_a, Ba,
        win_a, (uint4*)out_a, (const int*)starts_b, win_b, (uint4*)out_b);
  }
  return (int)cudaGetLastError();
}
