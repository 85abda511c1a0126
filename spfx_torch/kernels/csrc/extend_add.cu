// Row extend-add into a target slab, for sm_90a.
//
// Replaces spfx/kernels/pallas_blocks.py extend_add_rows: on the TPU the
// slab sits in VMEM, aliased onto its output, and a sequential row loop
// subtracts one row of E at a time, so repeated target rows simply follow
// one another.
//
// What it computes, in place on the slab (Rs, csp), row-major:
//   slab[rows[i], :] -= E[i, :]   for every i with rows[i] >= 0;
// rows[i] < 0 drops row i. Several rows of E may name the same slab row.
// A live row >= Rs is a plan error and traps (the host checks the plan
// once, and the CPU wrapper raises).
//
// What bounds it on the H100: memory. Each live row of E is read once,
// csp * itemsize bytes, and each distinct slab row that the live rows name
// is read and written once, 2 * csp * itemsize bytes (rows of E that share
// a slab row share its traffic), plus the (RE,) int32 table; one
// subtraction a value, far under the card's ridge, so the floor is those
// bytes over 3.35 TB/s.
//
// What the design does about it: one thread block per (row of E, chunk of
// up to 256 columns); the block reads its row's target once and a dropped
// row exits at once, before touching E. Neighbouring threads take
// neighbouring columns, so E's row and the slab row move in full sectors.
// Thread blocks run in no order, and two rows of E may land on one slab row
// in the same launch, so the subtraction is an atomicAdd of -e (native for
// float and double on Hopper); the sum order of repeated rows is therefore
// not fixed. Offsets are 64-bit.

#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
extend_add_kernel(T* __restrict__ slab, long long Rs, int csp,
                  const int* __restrict__ rows, const T* __restrict__ E) {
  const long long i = blockIdx.x;
  const long long t = rows[i];
  if (t < 0) return;
  if (t >= Rs) {
    if (threadIdx.x == 0 && blockIdx.y == 0)
      printf("extend_add_rows: row %lld of E targets slab row %lld, past "
             "the slab's %lld rows\n", i, t, Rs);
    __trap();
  }
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c < csp)
    atomicAdd(slab + t * csp + c, -E[i * csp + c]);
}

template <typename T>
int launch(void* slab, long long Rs, int csp, const void* rows,
           long long total, const void* E, void* stream) {
  if (csp < 1 || Rs < 0 || total < 0) return (int)cudaErrorInvalidValue;
  if (total > 0) {
    const int threads = csp >= kMaxThreads ? kMaxThreads
                                           : ((csp + 31) / 32) * 32;
    const dim3 grid((unsigned)total, (unsigned)((csp + threads - 1) / threads));
    extend_add_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (T*)slab, Rs, csp, (const int*)rows, (const T*)E);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// slab (Rs, csp) -= E (total, csp) at slab rows ``rows`` (total,) int32,
// in place; with total == 0 nothing is launched. Returns cudaGetLastError().
extern "C" int spfx_extend_add_rows_f32(void* slab, long long Rs, int csp,
                                        const void* rows, long long total,
                                        const void* E, void* stream) {
  return launch<float>(slab, Rs, csp, rows, total, E, stream);
}

extern "C" int spfx_extend_add_rows_f64(void* slab, long long Rs, int csp,
                                        const void* rows, long long total,
                                        const void* E, void* stream) {
  return launch<double>(slab, Rs, csp, rows, total, E, stream);
}
