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
// once, and the CPU wrapper raises). The twin entry (rows2) does the same
// on two slabs of one shape with two E at one row table, LU's factor
// arrays at one offset: the port's form of extend_add_region_lu's twin
// regions (spfx/kernels/blocks.py).
//
// What bounds it on the H100: memory. Each live row of E is read once,
// csp * itemsize bytes, and each distinct slab row that the live rows name
// is read and written once, 2 * csp * itemsize bytes (rows of E that share
// a slab row share its traffic), plus the (RE,) int32 table; one
// subtraction a value, far under the card's ridge, so the floor is those
// bytes over 3.35 TB/s. Most calls are small (over a 48^3 Cholesky the
// median call moves 0.5 MB), so a launch's fixed cost matters as much.
//
// What held the design this replaces (one thread block per row of E and
// chunk of 256 columns, a scalar atomicAdd a value): its grid. Timed in
// parts (spfx_torch/bench/kernel_probe.py extend) on the NVIDIA H100 80GB
// HBM3 at 700 W, the largest call of the 48^3 Cholesky took 15.6 us, of
// which 11.4 us remained with an empty kernel body on the same grid; over
// the plan's 1,126 calls 4.60 ms, 3.72 of it with an empty body, against
// a launch floor of 1.09 ms (an empty one-block kernel a call). Four rows
// of E in five are dropped, and each cost a thread block. Neither the
// atomics (plain stores in their place: no change) nor E's loads (cut:
// -0.1 ms over the path) held it.
//
// What the design does about it: one thread block per 32 consecutive rows
// of E. Its first warp reads the group's table in one 128-byte load, and
// a ballot gives the live rows, which it packs into shared memory; a
// dropped row costs one 4-byte read, a group with none live one barrier.
// Then all the block's threads walk the packed rows' values in 16-byte
// vectors (vec16.cuh), each thread taking a fixed column of a row (narrow
// rows: several rows at once), kUnroll vectors loaded (streaming: E is
// read once) before any is added. The block has threads enough for
// kUnroll vectors each when all 32 rows are live, up to kMaxThreads. The
// subtraction is a reduction: Hopper's vector red.global.add.v4.f32 in
// f32 (atomicAdd(float4*)), two scalar red.global.add.f64 a vector in
// f64. Thread blocks run in no order, and two rows of E may land on one
// slab row, so the sum order of repeated rows is not fixed. Where a row
// is no whole number of 16-byte vectors or a pointer is not 16-byte
// aligned (the wrapper's vector_path test), the same walk moves single
// values. Offsets are 64-bit. Templated on float and double.
//
// Measured and not kept: one warp per 32 rows, four warps a block (the
// path 8.8 ms: too few threads in flight for the data, the latency of
// each load and reduction paid in turn); blocks of at most 128 or 256
// threads and 4 or 8 vectors a thread, or a cap of 64 registers (the path
// 3.41-4.39 ms against 3.45, the largest call 9.4-10.5 us against 9.7).
// What remains is a call's chain of dependent latencies: launch, table,
// E, reduction.

#include <cstdio>
#include <cuda_runtime.h>

#include "vec16.cuh"

namespace {

constexpr int kMaxThreads = 512;   // threads a thread block, at most
constexpr int kUnroll = 2;         // units a thread loads before adding
// Parts that spfx_torch/bench/kernel_probe.py turns off in copies of this
// file, to time them; always on here.
constexpr bool kBody = true, kLoadE = true, kAtomic = true;

// the unit one lane moves: a 16-byte vector, or one value
template <typename T, bool kVec> struct Unit {
  using type = typename Vec<T>::type;
  static constexpr int n = Vec<T>::n;
};
template <typename T> struct Unit<T, false> {
  using type = T;
  static constexpr int n = 1;
};

__device__ __forceinline__ float neg(float x) { return -x; }
__device__ __forceinline__ double neg(double x) { return -x; }
__device__ __forceinline__ float4 neg(float4 x) {
  return make_float4(-x.x, -x.y, -x.z, -x.w);
}
__device__ __forceinline__ double2 neg(double2 x) {
  return make_double2(-x.x, -x.y);
}

// *p += x as a reduction (the result unused, so the card issues red)
__device__ __forceinline__ void red(float* p, float x) { atomicAdd(p, x); }
__device__ __forceinline__ void red(double* p, double x) { atomicAdd(p, x); }
__device__ __forceinline__ void red(float4* p, float4 x) { atomicAdd(p, x); }
__device__ __forceinline__ void red(double2* p, double2 x) {
  atomicAdd(&p->x, x.x);
  atomicAdd(&p->y, x.y);
}

template <typename U>
__device__ __forceinline__ void sub(U* p, U x) {
  if (kAtomic)
    red(p, neg(x));
  else
    *p = neg(x);
}

template <typename T, bool kVec, bool kTwin>
__global__ void __launch_bounds__(kMaxThreads)
extend_add_kernel(T* __restrict__ s0, T* __restrict__ s1, long long Rs,
                  int csp, const int* __restrict__ rows, long long RE,
                  const T* __restrict__ E0, const T* __restrict__ E1) {
  using U = typename Unit<T, kVec>::type;
  constexpr int kN = Unit<T, kVec>::n;
  __shared__ int tgt[32];            // the group's live rows: slab row
  __shared__ int src[32];            // and row of E within the group
  __shared__ int count;
  if (!kBody) return;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long g = (long long)blockIdx.x * 32;
  if (tid < 32) {
    const long long i = g + tid;
    const long long t = i < RE ? rows[i] : -1;
    if (t >= Rs) {
      printf("extend_add_rows: row %lld of E targets slab row %lld, past "
             "the slab's %lld rows\n", i, t, Rs);
      __trap();
    }
    const unsigned live = __ballot_sync(0xffffffffu, t >= 0);
    if (t >= 0) {
      const int pos = __popc(live & ((1u << tid) - 1u));
      tgt[pos] = (int)t;
      src[pos] = tid;
    }
    if (tid == 0) count = __popc(live);
  }
  __syncthreads();
  const int n = count;
  // thread -> (first row, first unit): a row of nu units takes span
  // threads; with nu <= nt a pass covers per = nt / span rows, else one
  // row in nu / nt steps
  const int nu = csp / kN;
  const int span = nu < nt ? nu : nt;
  const int per = nt / span;
  const int u0 = tid % span;
  int r = tid / span, u = u0;
  if (r >= per) return;
  while (r < n) {
    U x0[kUnroll], x1[kUnroll];
    long long d[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      d[k] = -1;
      if (r < n) {
        const long long e = (g + src[r]) * csp + (long long)u * kN;
        d[k] = (long long)tgt[r] * csp + (long long)u * kN;
        x0[k] = kLoadE ? __ldcs((const U*)(E0 + e)) : U{};
        if (kTwin) x1[k] = kLoadE ? __ldcs((const U*)(E1 + e)) : U{};
      }
      u += span;
      if (u >= nu) {
        u = u0;
        r += per;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (d[k] < 0) continue;
      sub((U*)(s0 + d[k]), x0[k]);
      if (kTwin) sub((U*)(s1 + d[k]), x1[k]);
    }
  }
}

template <typename T, bool kTwin>
int launch(void* s0, void* s1, long long Rs, int csp, const void* rows,
           long long RE, const void* E0, const void* E1, int vec,
           void* stream) {
  // slab rows are kept as int in shared memory
  if (csp < 1 || Rs < 0 || Rs > 0x7fffffff || RE < 0)
    return (int)cudaErrorInvalidValue;
  if (vec && csp * sizeof(T) % 16) return (int)cudaErrorInvalidValue;
  if (RE > 0) {
    // threads enough for kUnroll units each when all 32 rows are live
    const long long nu = vec ? csp * sizeof(T) / 16 : csp;
    long long nt = (32 * nu / kUnroll + 31) / 32 * 32;
    nt = nt < 32 ? 32 : (nt > kMaxThreads ? kMaxThreads : nt);
    auto kernel = vec ? extend_add_kernel<T, true, kTwin>
                      : extend_add_kernel<T, false, kTwin>;
    kernel<<<(unsigned)((RE + 31) / 32), (unsigned)nt, 0,
             (cudaStream_t)stream>>>((T*)s0, (T*)s1, Rs, csp,
                                     (const int*)rows, RE, (const T*)E0,
                                     (const T*)E1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// slab (Rs, csp) -= E (RE, csp) at slab rows ``rows`` (RE,) int32, in
// place; ``vec``: rows of whole 16-byte vectors on 16-byte aligned slab and
// E (else single values). With RE == 0 nothing is launched. Returns
// cudaGetLastError().
extern "C" int spfx_extend_add_rows_f32(void* slab, long long Rs, int csp,
                                        const void* rows, long long RE,
                                        const void* E, int vec,
                                        void* stream) {
  return launch<float, false>(slab, nullptr, Rs, csp, rows, RE, E, nullptr,
                              vec, stream);
}

extern "C" int spfx_extend_add_rows_f64(void* slab, long long Rs, int csp,
                                        const void* rows, long long RE,
                                        const void* E, int vec,
                                        void* stream) {
  return launch<double, false>(slab, nullptr, Rs, csp, rows, RE, E, nullptr,
                               vec, stream);
}

// The twin: slab_l -= EL and slab_u -= EU, both (Rs, csp) and (RE, csp), at
// one row table, in one launch.
extern "C" int spfx_extend_add_rows2_f32(void* slab_l, void* slab_u,
                                         long long Rs, int csp,
                                         const void* rows, long long RE,
                                         const void* EL, const void* EU,
                                         int vec, void* stream) {
  return launch<float, true>(slab_l, slab_u, Rs, csp, rows, RE, EL, EU, vec,
                             stream);
}

extern "C" int spfx_extend_add_rows2_f64(void* slab_l, void* slab_u,
                                         long long Rs, int csp,
                                         const void* rows, long long RE,
                                         const void* EL, const void* EU,
                                         int vec, void* stream) {
  return launch<double, true>(slab_l, slab_u, Rs, csp, rows, RE, EL, EU, vec,
                              stream);
}
