// Level solves of one PC panel bucket, forward and backward, for sm_90a:
// one launch a bucket and sweep.
//
// Replaces no Pallas kernel: the JAX package leaves the level solves to
// lax.linalg and XLA (spfx/kernels/blocks.py solve_fwd_level_c and
// solve_bwd_level_c), and the port ran them as a chain of some forty torch
// launches a bucket (gathers of L11 and L21 through index tensors, masks,
// a batched triangular solve, a product and an index_add_). This kernel
// reads the bucket's blocks where they lie in the factor and does the
// solve and the update in one launch.
//
// What it computes, in place on x (n + 1, nrhs), row-major, for every task
// t of the bucket with diag_start[t] >= 0 (w = widths[t] live columns,
// nb = nbelow[t] live rows below; L11 the w x w block at diag_start[t] and
// L21 the nb x w block at below_start[t], both with row stride cp):
//   forward:  y = L11^{-1} x[cols] (L11 unit when `unit`, LU's L);
//             x[cols] = y; x[rows] -= L21 y;
//   backward: t = x[cols] - L21^T x[rows]; x[cols] = L11^{-T} t (LU's F
//             is U^T, so L11^T is U's diagonal block; never unit).
// cols = xcols[t, :w], rows = xrows[t, :nb]. Pad tasks, dead columns and
// rows and -1 indices are skipped by predicate: the sentinel row n of x is
// never read or written. Several tasks may carry into one row below, so
// the forward update is an atomicAdd; sums over a task's rows are a
// reduction within the task and take none.
//
// What bounds it on the H100: latency. A 48^3 factor holds 26.1 M values
// and a sweep reads each once (0.031 ms of bytes at 3.35 TB/s in float32),
// over 395 launches in dependence order; each task's triangular solve is
// a chain of w dependent substitutions.
//
// Design: a thread block takes one task, one group of kRhs right-hand
// sides (a warp each in the diagonal solves) and one tile of `ch` rows of
// L21, so that a task with thousands of rows below, the top of the tree
// where a bucket holds one task, spreads over many SMs. y lives in shared
// memory, or, where the wrapper passes a workspace `yg` (a bucket too wide
// for y to fit beside the buffers), in global memory, one slice a thread
// block, where the same code reads and writes it. The factor comes in as
// a stream of 32-column chunks of at most `ch` rows (a "job"), each copied
// into a padded shared buffer with cp.async while the jobs before it are
// worked on, `nbuf` buffers deep: the solve waits on the arithmetic of its
// substitutions, not on a load.
//  - Forward, for each 32-column block k of L11: the chunks of its column
//    panel (rows k*32 .. w), the first holding the diagonal block, solved
//    by substitution (one lane a row, the solved value passed by shuffle),
//    the rest of the panel's rows updated in parallel; then this tile's
//    rows of L21 at those columns, whose products with y_k accumulate in
//    registers, one row a thread. Every tile of a task solves y itself;
//    only the last of them to have read x[cols] writes y there (each
//    counts its arrival in `cnt` once its read is done). At the end each
//    tile subtracts its rows' sums from x[rows] with atomicAdd.
//  - Backward: first this tile's rows of L21, 32 columns a job, summed
//    into L21^T x[rows] (a lane a column, a warp every eighth row, then
//    the warps' sums added in warp order). With
//    more than one tile the partial sums go to `ws`, and the last tile to
//    arrive adds them up in tile order (so the sum does not depend on
//    which tile came last) and goes on alone: t = x[cols] - the sum, then
//    for each block k from the last: the chunks of L11's row panel (rows
//    k*32 .. k*32 + 32, columns 0 .. k*32 + 32), copied transposed so
//    that a thread owns a column; the first holds the diagonal block,
//    solved by back substitution, and the columns left of it are updated.
// The factor's dtype throughout: FFMA or DFMA, no TF32. A diagonal
// block's reciprocals are taken in parallel before its substitution, and
// each quotient is the product by the reciprocal with one FMA correction
// (div_by): IEEE division's rounding, without a division on the chain of
// dependent steps.
// The wrapper zeroes `cnt` (one int a task and group) before each launch
// that spreads a task over more than one tile, and passes `yg` (B x tiles
// x groups slices of cpad x kRhs values) when y is to live in global
// memory. Offsets are 64-bit.
// Templated on float and double.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // threads a thread block
constexpr int kRhs = 8;              // right-hand sides a thread block
constexpr int kBlk = 32;             // diagonal block width
constexpr int kPad = kBlk + 1;       // a staged row, padded
constexpr int kChMax = kThreads;     // rows a job and a tile, at most
constexpr int kChMin = 2 * kBlk;     // ... at least: a buffer holds the
                                     // backward's kThreads x kRhs sums
static_assert(kChMin * kPad >= kThreads * kRhs, "see kChMin");
constexpr int kBufMax = 4;           // buffers in flight, at most
static_assert(kThreads / 32 == kRhs,
              "one warp a right-hand side in the diagonal solves");

struct Args {
  const int* widths;
  const int* nbelow;
  const int* diag_start;
  const int* below_start;
  const int* xcols;          // (B, cp)
  const int* xrows;          // (B, rbp)
  int* cnt;                  // (B, groups) arrivals, zeroed
  int cp, rbp, nrhs;
  int ch;                    // rows a job and a tile (kChMin .. kChMax)
  int nbuf;                  // staging buffers (2 .. kBufMax)
};

// --- asynchronous copies, global -> shared --------------------------------

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's groups are still in flight.
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// st[r][c] = F[base + (r0 + r) cp + c0 + c] for r < m, c < bw; 0 for
// c >= bw. A warp a row, a lane a column.
template <typename T>
__device__ __forceinline__ void stage_rows(T* st, const T* __restrict__ F,
                                           long long base, int cp, int r0,
                                           int m, int c0, int bw) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < m; r += kThreads / 32) {
    T* d = st + r * kPad + lane;
    if (lane < bw)
      cp_async(d, F + base + (long long)(r0 + r) * cp + c0 + lane);
    else
      *d = T(0);
  }
}

// st[r][c] = F[base + (c0 + c) cp + r0 + r] for r < m, c < bw (the
// transpose of rows c0 .. c0 + bw, columns r0 .. r0 + m); 0 for c >= bw.
// A thread a staged row (m <= kThreads).
template <typename T>
__device__ __forceinline__ void stage_cols(T* st, const T* __restrict__ F,
                                           long long base, int cp, int r0,
                                           int m, int c0, int bw) {
  const int r = threadIdx.x;
  if (r >= m) return;
#pragma unroll 8
  for (int c = 0; c < kBlk; ++c) {
    T* d = st + r * kPad + c;
    if (c < bw)
      cp_async(d, F + base + (long long)(c0 + c) * cp + r0 + r);
    else
      *d = T(0);
  }
}

// --- diagonal blocks -------------------------------------------------------

// y = v / d to within IEEE division's rounding, from rd = 1 / d: the
// product, then one correction by its residual (two FMAs), so that the
// substitution's chain waits on no division.
template <typename T>
__device__ __forceinline__ T div_by(T v, T d, T rd) {
  const T y = v * rd;
  return fma(fma(-y, d, v), rd, y);
}

// The forward substitution in diagonal block [c0, c0 + bw) of ys, with
// D[i][c] = L11[c0 + i][c0 + c]: warp j takes right-hand side j, lane i
// row i. Each lane takes its own row's reciprocal first, all in parallel.
template <typename T, bool kUnit>
__device__ __forceinline__ void diag_fwd(T* ys, const T* D, int c0, int bw,
                                         int g) {
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  if (j >= g) return;
  T v = ys[(c0 + lane) * kRhs + j];
  T d = T(1), rd = T(1);
  if (!kUnit && lane < bw) {
    d = D[lane * kPad + lane];
    rd = T(1) / d;
  }
#pragma unroll
  for (int c = 0; c < kBlk; ++c) {
    if (c < bw) {
      if (!kUnit && lane == c) v = div_by(v, d, rd);
      const T yc = __shfl_sync(0xffffffffu, v, c);
      if (lane > c && lane < bw) v -= D[lane * kPad + c] * yc;
    }
  }
  if (lane < bw) ys[(c0 + lane) * kRhs + j] = v;
}

// The back substitution with the block's transpose, with
// D[i][c] = L11[c0 + c][c0 + i] (so D is the upper-triangular block
// L11^T[c0.., c0..] stored by columns).
template <typename T>
__device__ __forceinline__ void diag_bwd(T* ys, const T* D, int c0, int bw,
                                         int g) {
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  if (j >= g) return;
  T v = ys[(c0 + lane) * kRhs + j];
  T d = T(1), rd = T(1);
  if (lane < bw) {
    d = D[lane * kPad + lane];
    rd = T(1) / d;
  }
#pragma unroll
  for (int c = kBlk - 1; c >= 0; --c) {
    if (c < bw) {
      if (lane == c) v = div_by(v, d, rd);
      const T yc = __shfl_sync(0xffffffffu, v, c);
      if (lane < c) v -= D[lane * kPad + c] * yc;
    }
  }
  if (lane < bw) ys[(c0 + lane) * kRhs + j] = v;
}

// v[0..kRhs) = p[0..kRhs), p 32-byte aligned (y's rows, in shared or in
// global memory, and the tile's x): two (float)
// or four (double) vector loads.
__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void ld8(const double* p, double* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = reinterpret_cast<const double2*>(p)[k];
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}
static_assert(kRhs == 8, "ld8 reads one row of right-hand sides");

// acc[j] += sum_c st[r][c] ys[c0 + c][j], c < kBlk.
template <typename T>
__device__ __forceinline__ void row_dot(T* acc, const T* st, const T* ys,
                                        int r, int c0) {
#pragma unroll
  for (int c = 0; c < kBlk; ++c) {
    const T l = st[r * kPad + c];
    T yv[kRhs];
    ld8(ys + (c0 + c) * kRhs, yv);
#pragma unroll
    for (int j = 0; j < kRhs; ++j) acc[j] += l * yv[j];
  }
}

// ys[row i] -= sum_c st[r][c] ys[c0 + c] for the staged rows r in
// [lo, m), row i = i0 + r: a thread a row.
template <typename T>
__device__ __forceinline__ void sub_rows(T* ys, const T* st, int c0, int i0,
                                         int lo, int m) {
  const int r = threadIdx.x;
  if (r < lo || r >= m) return;
  T acc[kRhs] = {};
  row_dot(acc, st, ys, r, c0);
#pragma unroll
  for (int j = 0; j < kRhs; ++j) ys[(i0 + r) * kRhs + j] -= acc[j];
}

// Whether this thread block is the last of its task's `ntiles` tiles to
// arrive (thread 0 counts; all threads get the answer).
__device__ __forceinline__ bool arrive(int* cnt, int ntiles, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(cnt, 1) == ntiles - 1;
  }
  __syncthreads();
  return *flag;
}

template <typename T>
__device__ __forceinline__ T* smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// This thread block's y (cpad x kRhs): its slice of yg when given, else
// the start of shared memory.
template <typename T>
__device__ __forceinline__ T* y_of(T* yg, int cpad) {
  if (yg == nullptr) return smem<T>();
  const long long blk =
      ((long long)blockIdx.x * gridDim.y + blockIdx.y) * gridDim.z
      + blockIdx.z;
  return yg + blk * cpad * kRhs;
}

// v[j] = x[g, j0 + j] for j < ng (0 past ng, and everywhere for g < 0):
// the loads issued together.
template <typename T>
__device__ __forceinline__ void x_row(T* v, const T* x, int gr, int nrhs,
                                      int j0, int ng) {
#pragma unroll
  for (int j = 0; j < kRhs; ++j)
    v[j] = (gr >= 0 && j < ng) ? x[(long long)gr * nrhs + j0 + j] : T(0);
}

// ys[c] = x[cols[c], group] for c < w, 0 up to cpad: a thread a column.
template <typename T>
__device__ __forceinline__ void load_cols(T* ys, const T* x, const int* cols,
                                          int w, int cpad, int nrhs, int j0,
                                          int g) {
  for (int c = threadIdx.x; c < cpad; c += kThreads) {
    T v[kRhs];
    x_row(v, x, c < w ? cols[c] : -1, nrhs, j0, g);
#pragma unroll
    for (int j = 0; j < kRhs; ++j) ys[c * kRhs + j] = v[j];
  }
}

template <typename T>
__device__ __forceinline__ void store_cols(T* x, const T* ys,
                                           const int* cols, int w, int nrhs,
                                           int j0, int g) {
  for (int c = threadIdx.x; c < w; c += kThreads) {
    const int gc = cols[c];
    if (gc < 0) continue;
#pragma unroll
    for (int j = 0; j < kRhs; ++j)
      if (j < g) x[(long long)gc * nrhs + j0 + j] = ys[c * kRhs + j];
  }
}

// --- the job streams ---------------------------------------------------------

// Forward: for each block c0 of L11, the chunks of its column panel (rows
// c0 + r .. , r a multiple of ch, below = 0), then this tile's rows of L21
// (below = 1) if it has any.
struct FwdJob {
  int c0, r, below;
  __device__ bool done(int w) const { return c0 >= w; }
  __device__ void next(int w, int ch, int mt) {
    if (!below) {
      r += ch;
      if (c0 + r < w) return;
      if (mt > 0) { below = 1; return; }
    }
    below = 0;
    r = 0;
    c0 += kBlk;
  }
};

// Backward: phase 0, for each block c0 of L21 (this tile's rows); phase 1,
// for each block c0 of L11 from the last, the chunks [lo, hi) of its row
// panel's columns from hi = c0 + bw down to 0.
struct BwdJob {
  int phase, c0, lo, hi;
  __device__ bool done() const { return phase > 1; }
  __device__ void start_b(int w, int ch) {
    phase = 1;
    c0 = (w - 1) / kBlk * kBlk;
    hi = w;
    lo = max(0, hi - ch);
  }
  __device__ void next(int w, int ch) {
    if (phase == 0) {
      c0 += kBlk;
      if (c0 >= w) start_b(w, ch);
      return;
    }
    if (lo > 0) {
      hi = lo;
      lo = max(0, hi - ch);
      return;
    }
    c0 -= kBlk;
    if (c0 < 0) { phase = 2; return; }
    hi = c0 + kBlk;
    lo = max(0, hi - ch);
  }
};

// grid (B, tiles, groups): blockIdx.x the task, .y the tile of L21's rows,
// .z the group of right-hand sides.
template <typename T, bool kUnit>
__global__ void __launch_bounds__(kThreads)
level_fwd_kernel(const T* __restrict__ F, T* x, T* yg, Args a) {
  __shared__ int flag;
  const int t = blockIdx.x, tile = blockIdx.y, grp = blockIdx.z;
  const int ds = a.diag_start[t], w = a.widths[t];
  if (ds < 0 || w <= 0) return;
  const int ch = a.ch, cp = a.cp, nrhs = a.nrhs;
  const int nb = a.rbp ? a.nbelow[t] : 0;
  const int ntiles = nb > ch ? (nb + ch - 1) / ch : 1;
  if (tile >= ntiles) return;
  const int cpad = (cp + kBlk - 1) / kBlk * kBlk;
  const int j0 = grp * kRhs, g = min(kRhs, nrhs - j0);
  const int r0t = tile * ch, mt = nb > 0 ? min(ch, nb - r0t) : 0;
  const long long bs = a.below_start[t];
  const int* cols = a.xcols + (long long)t * cp;
  T* ys = y_of(yg, cpad);                 // y: cpad x kRhs
  T* bufs = smem<T>() + (yg ? 0 : cpad * kRhs);   // nbuf x (ch x kPad)
  const int bsz = ch * kPad, nbuf = a.nbuf;
  const int tid = threadIdx.x;

  auto issue = [&](const FwdJob& jb, T* st) {
    const int bw = min(kBlk, w - jb.c0);
    if (jb.below)
      stage_rows(st, F, bs, cp, r0t, mt, jb.c0, bw);
    else
      stage_rows(st, F, ds, cp, jb.c0 + jb.r, min(ch, w - jb.c0 - jb.r),
                 jb.c0, bw);
    cp_commit();
  };

  // the first jobs go out before x is read
  FwdJob nx{0, 0, 0};
  int issued = 0;
  for (; issued < nbuf - 1 && !nx.done(w); ++issued) {
    issue(nx, bufs + (issued % nbuf) * bsz);
    nx.next(w, ch, mt);
  }
  load_cols(ys, x, cols, w, cpad, nrhs, j0, g);
  const bool last = ntiles == 1 ||
      arrive(a.cnt + (long long)t * gridDim.z + grp, ntiles, &flag);

  T acc[kRhs] = {};                       // this thread's row of L21 y
  FwdJob jb{0, 0, 0};
  for (int done = 0; !jb.done(w); ++done) {
    if (!nx.done(w)) {
      issue(nx, bufs + (issued % nbuf) * bsz);
      nx.next(w, ch, mt);
      ++issued;
    }
    cp_wait(issued - done - 1);
    __syncthreads();
    const T* st = bufs + (done % nbuf) * bsz;
    const int c0 = jb.c0, bw = min(kBlk, w - c0);
    if (jb.below) {
      if (tid < mt) row_dot(acc, st, ys, tid, c0);
    } else {
      const int m = min(ch, w - c0 - jb.r);
      if (jb.r == 0) {
        diag_fwd<T, kUnit>(ys, st, c0, bw, g);
        __syncthreads();
        sub_rows(ys, st, c0, c0, bw, m);
      } else {
        sub_rows(ys, st, c0, c0 + jb.r, 0, m);
      }
    }
    __syncthreads();
    jb.next(w, ch, mt);
  }
  if (last) store_cols(x, ys, cols, w, nrhs, j0, g);
  if (tid < mt) {
    const int gr = a.xrows[(long long)t * a.rbp + r0t + tid];
    if (gr >= 0) {
      for (int j = 0; j < g; ++j)
        atomicAdd(&x[(long long)gr * nrhs + j0 + j], -acc[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
level_bwd_kernel(const T* __restrict__ F, T* x, T* yg, T* ws, Args a) {
  __shared__ int flag;
  const int t = blockIdx.x, tile = blockIdx.y, grp = blockIdx.z;
  const int ds = a.diag_start[t], w = a.widths[t];
  if (ds < 0 || w <= 0) return;
  const int ch = a.ch, cp = a.cp, nrhs = a.nrhs;
  const int nb = a.rbp ? a.nbelow[t] : 0;
  const int ntiles = nb > ch ? (nb + ch - 1) / ch : 1;
  if (tile >= ntiles) return;
  const int cpad = (cp + kBlk - 1) / kBlk * kBlk;
  const int j0 = grp * kRhs, g = min(kRhs, nrhs - j0);
  const int r0t = tile * ch, mt = nb > 0 ? min(ch, nb - r0t) : 0;
  const long long bs = a.below_start[t];
  const int* cols = a.xcols + (long long)t * cp;
  T* ys = y_of(yg, cpad);                 // cpad x kRhs
  // this tile's x[rows]: ch x kRhs
  T* xs = smem<T>() + (yg ? 0 : cpad * kRhs);
  T* bufs = xs + ch * kRhs;               // nbuf x (ch x kPad)
  const int bsz = ch * kPad, nbuf = a.nbuf;
  const int tid = threadIdx.x, lane = tid & 31, wj = tid >> 5;

  auto issue = [&](const BwdJob& jb, T* st) {
    const int bw = min(kBlk, w - jb.c0);
    if (jb.phase == 0)
      stage_rows(st, F, bs, cp, r0t, mt, jb.c0, bw);
    else
      stage_cols(st, F, ds, cp, jb.lo, jb.hi - jb.lo, jb.c0, bw);
    cp_commit();
  };

  BwdJob nx{0, 0, 0, 0};
  if (mt == 0) nx.start_b(w, ch);
  const BwdJob first = nx;
  int issued = 0;
  for (; issued < nbuf - 1 && !nx.done(); ++issued) {
    issue(nx, bufs + (issued % nbuf) * bsz);
    nx.next(w, ch);
  }
  for (int i = tid; i < cpad * kRhs; i += kThreads) ys[i] = T(0);
  if (tid < mt) {
    T v[kRhs];
    x_row(v, x, a.xrows[(long long)t * a.rbp + r0t + tid], nrhs, j0, g);
#pragma unroll
    for (int j = 0; j < kRhs; ++j) xs[tid * kRhs + j] = v[j];
  }

  BwdJob jb = first;
  T* part = nullptr;                     // this task's tiles' sums in ws
  for (int done = 0; !jb.done(); ++done) {
    if (jb.phase == 1 && jb.hi == w) {
      // phase 1 begins: the tiles' sums meet, t = x[cols] - the sum
      __syncthreads();
      if (ntiles > 1) {
        part = ws + ((long long)t * gridDim.z + grp) * gridDim.y
               * cpad * kRhs;
        for (int i = tid; i < w * kRhs; i += kThreads)
          part[(long long)tile * cpad * kRhs + i] = ys[i];
        __threadfence();
        if (!arrive(a.cnt + (long long)t * gridDim.z + grp, ntiles,
                    &flag)) {
          cp_wait(0);
          return;
        }
        __threadfence();
      }
      // a thread a column: the tiles' sums in tile order, x[cols] beside
      for (int c = tid; c < w; c += kThreads) {
        T b[kRhs], sum[kRhs];
        x_row(b, x, cols[c], nrhs, j0, g);
        if (ntiles > 1) {
          const T* pc = part + c * kRhs;
#pragma unroll
          for (int j = 0; j < kRhs; ++j) sum[j] = __ldcg(pc + j);
          for (int k = 1; k < ntiles; ++k) {
            T v[kRhs];
#pragma unroll
            for (int j = 0; j < kRhs; ++j)
              v[j] = __ldcg(pc + (long long)k * cpad * kRhs + j);
#pragma unroll
            for (int j = 0; j < kRhs; ++j) sum[j] += v[j];
          }
        } else {
          ld8(ys + c * kRhs, sum);
        }
#pragma unroll
        for (int j = 0; j < kRhs; ++j) ys[c * kRhs + j] = b[j] - sum[j];
      }
    }
    if (!nx.done()) {
      issue(nx, bufs + (issued % nbuf) * bsz);
      nx.next(w, ch);
      ++issued;
    }
    cp_wait(issued - done - 1);
    __syncthreads();
    T* st = bufs + (done % nbuf) * bsz;
    const int c0 = jb.c0, bw = min(kBlk, w - c0);
    if (jb.phase == 0) {
      // ys[c0 + lane][j] = sum over this tile's rows r of L21[r][c0 + lane]
      // x[rows[r]][j]: warp wj sums rows wj, wj + 8, ..., then the warps'
      // sums meet in the buffer, which is read (ch >= 64 rows of kPad hold
      // kThreads x kRhs values)
      T acc[kRhs] = {};
      for (int r = wj; r < mt; r += kThreads / 32) {
        const T l = st[r * kPad + lane];
        T xv[kRhs];
        ld8(xs + r * kRhs, xv);
#pragma unroll
        for (int j = 0; j < kRhs; ++j) acc[j] += l * xv[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRhs; ++j) st[(wj * kRhs + j) * 32 + lane] = acc[j];
      __syncthreads();
      if (lane < bw && wj < g) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < kThreads / 32; ++k)
          s += st[(k * kRhs + wj) * 32 + lane];
        ys[(c0 + lane) * kRhs + wj] = s;
      }
    } else if (jb.hi == c0 + bw) {
      const int m = jb.hi - jb.lo;
      diag_bwd(ys, st + (m - bw) * kPad, c0, bw, g);
      __syncthreads();
      sub_rows(ys, st, c0, jb.lo, 0, m - bw);
    } else {
      sub_rows(ys, st, c0, jb.lo, 0, jb.hi - jb.lo);
    }
    __syncthreads();
    jb.next(w, ch);
  }
  store_cols(x, ys, cols, w, nrhs, j0, g);
}

// Shared memory a thread block: y (unless it lives in yg), the tile's x,
// the staging buffers.
template <typename T>
size_t smem_bytes(int cp, int ch, int nbuf, bool y_global) {
  const int cpad = (cp + kBlk - 1) / kBlk * kBlk;
  return sizeof(T) * ((y_global ? 0 : (size_t)cpad * kRhs)
                      + (size_t)ch * kRhs + (size_t)nbuf * ch * kPad);
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

dim3 grid_of(int B, int rbp, int nrhs, int ch) {
  return dim3(B, rbp > ch ? (rbp + ch - 1) / ch : 1,
              (nrhs + kRhs - 1) / kRhs);
}

bool bad_shape(int ch, int nbuf) {
  return ch < kChMin || ch > kChMax || ch % kBlk || nbuf < 2
      || nbuf > kBufMax;
}

template <typename T>
int launch_fwd(const T* F, T* x, const int* widths, const int* nbelow,
               const int* diag_start, const int* below_start,
               const int* xcols, const int* xrows, T* yg, int* cnt, int B,
               int cp, int rbp, int nrhs, int ch, int nbuf, int unit,
               void* stream) {
  if (bad_shape(ch, nbuf)) return cudaErrorInvalidValue;
  const Args a{widths, nbelow, diag_start, below_start, xcols, xrows, cnt,
               cp, rbp, nrhs, ch, nbuf};
  const size_t bytes = smem_bytes<T>(cp, ch, nbuf, yg != nullptr);
  auto kern = unit ? &level_fwd_kernel<T, true> : &level_fwd_kernel<T, false>;
  cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  if (B > 0 && nrhs > 0)
    kern<<<grid_of(B, rbp, nrhs, ch), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(F, x, yg, a);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* F, T* x, const int* widths, const int* nbelow,
               const int* diag_start, const int* below_start,
               const int* xcols, const int* xrows, T* yg, T* ws, int* cnt,
               int B, int cp, int rbp, int nrhs, int ch, int nbuf,
               void* stream) {
  if (bad_shape(ch, nbuf)) return cudaErrorInvalidValue;
  const Args a{widths, nbelow, diag_start, below_start, xcols, xrows, cnt,
               cp, rbp, nrhs, ch, nbuf};
  const size_t bytes = smem_bytes<T>(cp, ch, nbuf, yg != nullptr);
  auto kern = &level_bwd_kernel<T>;
  cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  if (B > 0 && nrhs > 0)
    kern<<<grid_of(B, rbp, nrhs, ch), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(F, x, yg, ws, a);
  return cudaGetLastError();
}

}  // namespace

// (F, x, widths, nbelow, diag_start, below_start, xcols, xrows, yg, cnt, B,
// cp, rbp, nrhs, ch, nbuf, unit, stream); yg null: y in shared memory
extern "C" int spfx_level_solve_fwd_f32(
    const float* F, float* x, const int* widths, const int* nbelow,
    const int* diag_start, const int* below_start, const int* xcols,
    const int* xrows, float* yg, int* cnt, int B, int cp, int rbp, int nrhs,
    int ch, int nbuf, int unit, void* stream) {
  return launch_fwd<float>(F, x, widths, nbelow, diag_start, below_start,
                           xcols, xrows, yg, cnt, B, cp, rbp, nrhs, ch, nbuf,
                           unit, stream);
}

extern "C" int spfx_level_solve_fwd_f64(
    const double* F, double* x, const int* widths, const int* nbelow,
    const int* diag_start, const int* below_start, const int* xcols,
    const int* xrows, double* yg, int* cnt, int B, int cp, int rbp, int nrhs,
    int ch, int nbuf, int unit, void* stream) {
  return launch_fwd<double>(F, x, widths, nbelow, diag_start, below_start,
                            xcols, xrows, yg, cnt, B, cp, rbp, nrhs, ch,
                            nbuf, unit, stream);
}

// (F, x, widths, nbelow, diag_start, below_start, xcols, xrows, yg, ws, cnt,
// B, cp, rbp, nrhs, ch, nbuf, stream)
extern "C" int spfx_level_solve_bwd_f32(
    const float* F, float* x, const int* widths, const int* nbelow,
    const int* diag_start, const int* below_start, const int* xcols,
    const int* xrows, float* yg, float* ws, int* cnt, int B, int cp, int rbp,
    int nrhs, int ch, int nbuf, void* stream) {
  return launch_bwd<float>(F, x, widths, nbelow, diag_start, below_start,
                           xcols, xrows, yg, ws, cnt, B, cp, rbp, nrhs, ch,
                           nbuf, stream);
}

extern "C" int spfx_level_solve_bwd_f64(
    const double* F, double* x, const int* widths, const int* nbelow,
    const int* diag_start, const int* below_start, const int* xcols,
    const int* xrows, double* yg, double* ws, int* cnt, int B, int cp, int rbp,
    int nrhs, int ch, int nbuf, void* stream) {
  return launch_bwd<double>(F, x, widths, nbelow, diag_start, below_start,
                            xcols, xrows, yg, ws, cnt, B, cp, rbp, nrhs, ch,
                            nbuf, stream);
}
