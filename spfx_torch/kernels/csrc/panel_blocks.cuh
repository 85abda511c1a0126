// Whole-panel Cholesky and no-pivot LU deltas, blocked by 32 columns: the
// device code that the two layouts share, sm_90a.
//
// Included by panel_lanes.cu and panel_wide.cu, which replace
// spfx/kernels/pallas_blocks.py chol/lu_panel_deltas_lanes and
// chol/lu_panel_deltas_wide: one call factors every panel of one PC
// bucket, panel width cp <= 256, and returns the deltas (new - old) that
// the router in spfx_torch/kernels/blocks.py adds onto the panels. The two
// families compute the same function on the caller's arrays in two
// layouts, so everything here is templated on a layout policy (Lay) that
// says where element f = i*cp + c of task b's diagonal window (Lay::diag)
// and element f = r*cp + c of its below block (Lay::below) lie:
//   lanes, the TPU lanes kernels' own, the tasks on the vector lanes:
//     diagonal windows (cp, cp, B) and below blocks (rbp, cp, B) at f*B + b;
//   task-major, the TPU wide kernels' own:
//     diagonal windows (B, cp, cp) at b*cp*cp + f,
//     below blocks    (B, rbp, cp) at b*rbp*cp + f.
// A copy loop walks f itself (batched's e), so an element costs one
// multiply-add in lanes and one add in task-major. At B = 1 the two
// layouts are the same bytes. At larger B a row of a task-major block is
// contiguous, where the lanes layout puts each of its values in another
// 32-byte sector. Nothing else differs: the workspace is task-major in
// both. Each .cu file holds its policy, the __global__
// wrappers under their own names (chol_diag_lanes, ..., lu_below_wide),
// which call the bodies below, and its extern "C" entry points.
//
// What it computes, per task b with w = clamp(widths[b], 0, cp) live
// columns and nb = clamp(nbelow[b], 0, rbp) live below rows:
//   Cholesky: L11 = chol of D's lower triangle on the live block (the upper
//     triangle is never read); dd = L11 - D on the live block, 0 elsewhere
//     (so dd = -D above the diagonal); L21 = B L11^{-T} on the live
//     columns; db = L21 - B on the live rows and columns, 0 elsewhere.
//   LU: the front D = DL on and below the diagonal, DU^T above it (live
//     block); its no-pivot LU, L11 unit lower, U11 upper; ddl = L11 - DL,
//     ddu = U11^T - DU on the live block; L21 = BL U11^{-1}, U12^T =
//     BU L11^{-T} (unit); dbl = L21 - BL, dbu = U12^T - BU on the live rows
//     and columns. The TPU kernel pads the front with the identity; the
//     padding never meets the live block, so this one skips it.
//
// The TPU kernels factor L11 (and U11) at grid step ri == 0 and keep it in
// scratch for the later row-block steps: a TPU grid runs in order. Thread
// blocks on the card run in no order, so each call is TWO launches on the
// caller's stream: a diagonal phase (one thread block per task) that writes
// the factor into a workspace the wrapper allocated, then a phase that
// reads it. The wrapper counts the pair as one launch of the kernel.
//
// What bounds it on the H100: at the path's heaviest call (cp 256, rbp
// 2560, B 1) about 173 MFLOP against 5.6 MB in f32 (2.5 us at 67 TFLOP/s),
// so operations, for Cholesky, and twice that for LU (two below solves, an
// LU of the front); nearly all of them are the below solves (rbp w^2 each),
// not the factorization. The TPU kernels' column recurrences suit its
// lanes when B >= 128; at B = 1 on the card they are a chain of w
// dependent steps on one SM. What the design does about it, in both
// layouts:
//
// Cholesky: blocked by 32 columns over explicit inverses of the 32 x 32
// diagonal blocks, so that everything outside a 32 x 32 factorization is a
// product with no dependent chain. Workspace W (B, cp + 32, ldw), ldw = cp
// rounded up to 32, row-major: rows 0..cp-1 the trailing matrix, which
// becomes L11; rows cp..cp+31, columns 32s..32s+31 the inverse of diagonal
// block s.
// - diagonal phase (chol_diag_*, one thread block per task, 512
//   threads in f32, 256 in f64): right-looking over the 32-column blocks,
//   one block ahead. The panel sits transposed in shared memory; one warp
//   factors its diagonal block in registers (potrf_inv.cu's column
//   recurrence, the identity past w) and inverts it; all warps form the
//   rows below it, P = A_is Linv^T, then the next panel's update
//   A22[:, :32] -= P P[:32]^T straight into shared memory; then one warp
//   factors the next diagonal block while the others update the rest of
//   the trailing lower triangle. Products run in 4 x 4 register tiles from
//   operands read four at a time. The first step reads D's lower triangle
//   itself, so D is never copied; w/32 block steps instead of w column
//   steps.
// - second phase (chol_below_*, grid (B, ceil(rbp/32) + ceil(cp/32)), 128
//   threads): a block stages 32 rows of B in shared memory and solves
//   them in place, block by block: acc = B_s - X_{<s} L11[s, <s]^T (L11's
//   32 x 32 tiles fetched from the workspace, which sits in L2, during the
//   product before them), then X_s = acc Linv_ss^T, 2 x 4 outputs a
//   thread; 80 thread blocks at rbp 2560, B 1. The last ceil(cp/32) blocks
//   of a task write dd = L11 - D, 32 rows each: one thread block alone
//   would take long over that copy.
// A thread block alone on its SM has few warps, so its copy loops keep
// eight loads in flight per thread (batched). No atomics, no host sync, no
// allocation: a call captures in a CUDA graph. Plain FP32/FP64 FMAs.
//
// LU: the same blocking, with explicit inverses of both 32 x 32 diagonal
// factors. Workspace W (B, cp + 64, ldw), row-major: rows 0..cp-1 the
// trailing matrix, which becomes the combined factor (L strictly below the
// diagonal, U on and above it); rows cp..cp+31 and cp+32..cp+63, columns
// 32s..32s+31, Linv and Uinv of diagonal block s.
// - diagonal phase (lu_diag_*, one thread block per task, threads as
//   for Cholesky): right-looking over the 32-column blocks, one block
//   ahead. Warp 0 factors the diagonal block, staged in shared memory, in
//   registers without pivoting (getrf_inv.cu's recurrence: lane i holds
//   row i, the pivot comes by shuffle and divides; the identity past w);
//   then warp 0 forms Linv and warp 1 Uinv (from the pivots' reciprocals),
//   side by side. All warps form the L panel below the block, A_is Uinv,
//   and the U panel right of it, Linv A_si, in place in shared memory (the
//   L panel transposed) and into the workspace; then the next diagonal
//   block's update goes to shared memory, and warps 0 and 1 factor it while
//   the others update the rest of the trailing square, A22 -= L_is U_si,
//   in 4 x 4 register tiles. In f32 the tiles of the next panels go to a
//   second pair of panel buffers in shared memory; f64 at cp 256 has room
//   for one pair, so they go to the workspace (in L2) and the next step
//   stages them from there. The first step reads DL and DU^T themselves.
// - second phase (lu_below_*, grid (B, 2 ceil(rbp/32) + 2 ceil(cp/32)),
//   128 threads): the Cholesky kernel's tile solve (below_tile), once for
//   each of the two independent solves: BL tiles against U11 (its tiles as
//   stored, X_s = acc Uinv_ss), BU tiles against L11 (its tiles
//   transposed, X_s = acc Linv_ss^T); 160 thread blocks at rbp 2560, B 1.
//   The last blocks of a task write ddl = L11 - DL and ddu = U11^T - DU,
//   32 rows each; ddu reads U11 by columns, so it goes through shared
//   memory transposed. It runs for rbp = 0 too.
// Templated on float and double.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCp = 256;       // widest panel either family covers
constexpr int kPanel = 32;        // columns of a block step
constexpr int kLdT = kPanel + 4;  // row of a staged tile read 4 at a time
constexpr int kLdD = kPanel + 1;  // row of the staged LU diagonal block
constexpr int kBatch = 8;         // loads in flight per thread in a copy
constexpr int kRT = 32;           // below rows per thread block (Cholesky)
constexpr int kRowThreads = 128;  // 16 x 8 threads, 2 x 4 outputs each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// Cholesky; workspace W (B, cp + 32, ldw) as in the header
// ---------------------------------------------------------------------------

// for (e = threadIdx.x; e < rows * cols; e += blockDim.x), with (r, c) the
// row and column of e: store(e, r, c, load(e, r, c)). The loads of kBatch
// iterations are in flight together, and (r, c) advance without a
// division: a thread block that works alone on a task has few warps, so a
// copy loop is bound by latency and by its instruction count.
template <typename T, typename Load, typename Store>
__device__ __forceinline__ void batched(int rows, int cols, Load load,
                                        Store store) {
  const int nt = blockDim.x, n = rows * cols;
  const int dr = nt / cols, dc = nt % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * nt) {
    T v[kBatch];
    int rs[kBatch], cs[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      rs[u] = r;
      cs[u] = c;
      v[u] = e0 + u * nt < n ? load(e0 + u * nt, r, c) : T(0);
      r += dr;
      c += dc;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e0 + u * nt < n) store(e0 + u * nt, rs[u], cs[u], v[u]);
  }
}

// four consecutive values at a 16-byte aligned address
__device__ __forceinline__ void ld4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double v[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}
__device__ __forceinline__ void st4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double v[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Warp 0: factor the diagonal block of the staged panel Qt (Qt[c*ldq + i]
// holds A[s+i][s+c]; pw live columns, the identity past them), overwrite
// the block in Qt with its factor, write the factor's live part to rows s..
// of Wb and its inverse to Lit (Lit[k*kLdT + j] = Linv[j][k]) and to rows
// cp.. of Wb (Linv[i][j] at row cp + i, column s + j).
template <typename T>
__device__ void factor_diag_block(T* Qt, int ldq, T* Lit, T* Dv, T* Wb,
                                  int s, int pw, int cp, int ldw) {
  const int lane = threadIdx.x;
  T a[kPanel];                    // lane i: row i of the block
#pragma unroll
  for (int c = 0; c < kPanel; ++c)
    a[c] = lane < pw ? (c <= lane ? Qt[c * ldq + lane] : T(0))
                     : (c == lane ? T(1) : T(0));
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const T piv = rsqrt_t(__shfl_sync(kFull, a[j], j));
    if (lane >= j) a[j] *= piv;
    if (lane == 0) Dv[j] = piv;                       // 1 / L[j][j]
#pragma unroll
    for (int k = j + 1; k < kPanel; ++k) {
      const T lkj = __shfl_sync(kFull, a[j], k);      // L[k][j]
      if (lane >= k) a[k] -= a[j] * lkj;
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kPanel; ++c) Qt[c * ldq + lane] = a[c];
  __syncwarp();
  // forward substitution, two partial sums; lane j: column j of Linv
  T x[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    T acc0 = T(0), acc1 = T(0);
#pragma unroll
    for (int k = 0; k + 1 < i; k += 2) {
      acc0 += Qt[k * ldq + i] * x[k];
      acc1 += Qt[(k + 1) * ldq + i] * x[k + 1];
    }
    if (i & 1) acc0 += Qt[(i - 1) * ldq + i] * x[i - 1];
    x[i] = ((i == lane ? T(1) : T(0)) - (acc0 + acc1)) * Dv[i];
  }
  if (lane < pw)
    for (int r = 0; r < pw; ++r)
      Wb[(long long)(s + r) * ldw + s + lane] = Qt[lane * ldq + r];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    Lit[lane * kLdT + i] = x[i];
    Wb[(long long)(cp + i) * ldw + s + lane] = x[i];
  }
}

// threads of a diagonal phase: as many warps as the registers of the
// factorization's warp allow (more warps hide more of the latency of a
// thread block that is alone on its SM)
template <typename T>
constexpr int panel_diag_threads() { return sizeof(T) == 4 ? 512 : 256; }

// The body of chol_diag_*: one thread block per task.
template <typename T, typename Lay>
__device__ __forceinline__ void chol_diag(const int* __restrict__ widths,
                                          const T* __restrict__ D,
                                          T* __restrict__ W, Lay lay,
                                          int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = ldw + 4;               // staged rows, read 4 at a time
  T* Qt = reinterpret_cast<T*>(smem);    // (32 x ldq) the panel, transposed
  T* Pt = Qt + kPanel * ldq;             // (32 x ldw) its rows below the
                                         // diagonal block, transposed
  T* Lit = Pt + kPanel * ldw;            // (32 x kLdT) the block's inverse
  T* Dv = Lit + kPanel * kLdT;           // (32) 1 / diagonal of the factor
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, nwarps = blockDim.x / 32;
  const int ty = tid % 32 / 8, tx = tid % 8;  // a warp's 4 x 8 grid of 4 x 4
  const int cp = lay.cp, w = clampi(widths[b], cp);
  T* Wb = W + (long long)b * (cp + kPanel) * ldw;
  if (w == 0) return;
  // the first panel, from D's lower triangle
  const int pw0 = min(kPanel, w);
  batched<T>(w, kPanel, [&](int, int i, int c) {
    return c < pw0 && c <= i ? D[lay.diag((long long)i * cp + c, b)] : T(0);
  }, [&](int, int i, int c, T v) { Qt[c * ldq + i] = v; });
  __syncthreads();
  if (tid < kPanel) factor_diag_block(Qt, ldq, Lit, Dv, Wb, 0, pw0, cp, ldw);
  __syncthreads();
  // right-looking over 32-column blocks, one block ahead: the next panel's
  // update goes to Qt first, so that one warp factors the next diagonal
  // block while the others update the rest of the trailing matrix. The
  // first step reads D's lower triangle, later ones the workspace.
  for (int s = 0; s + kPanel < w; s += kPanel) {
    const int t = w - s - kPanel;        // rows below the diagonal block
    // the panel's rows below the block: P = A_is Linv^T, to Wb and, zero
    // past row t up to a multiple of 32, to Pt; warp tiles of 16 rows x 32
    // columns (Linv is exactly 0 above its diagonal)
    for (int R = warp; R < (t + 31) / 32 * 2; R += nwarps) {
      T acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kPanel; ++k) {
        T u[4], v[4];
        ld4(Qt + k * ldq + kPanel + 16 * R + 4 * ty, u);
        ld4(Lit + k * kLdT + 4 * tx, v);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] += u[m] * v[n];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 16 * R + 4 * ty + m;
        if (i < t) {
          st4(Wb + (long long)(s + kPanel + i) * ldw + s + 4 * tx, acc[m]);
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = T(0);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const T col[4] = {acc[0][n], acc[1][n], acc[2][n], acc[3][n]};
        st4(Pt + (4 * tx + n) * ldw + 16 * R + 4 * ty, col);
      }
    }
    __syncthreads();
    // trailing update A22 -= P P^T by warp tiles of 16 rows x 32 columns,
    // rows 16R + 4ty + m, columns 32C + 4tx + n; whole tiles (the upper
    // triangle is never read); the old values load during the product
    const int nR = (t + 15) / 16, nC = (t + 31) / 32;
    T* A22 = Wb + (long long)(s + kPanel) * ldw + s + kPanel;
    auto update = [&](int R, int C, T (&acc)[4][4]) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 16 * R + 4 * ty + m;
        if (i >= t) {
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = T(0);
        } else if (s > 0) {
          ld4(A22 + (long long)i * ldw + 32 * C + 4 * tx, acc[m]);
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int c = 32 * C + 4 * tx + n;
            const long long f = (long long)(kPanel + i) * cp + kPanel + c;
            acc[m][n] = c <= i ? D[lay.diag(f, b)] : T(0);
          }
        }
      }
      T prod[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kPanel; ++k) {
        T u[4], v[4];
        ld4(Pt + k * ldw + 16 * R + 4 * ty, u);
        ld4(Pt + k * ldw + 32 * C + 4 * tx, v);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) prod[m][n] += u[m] * v[n];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] -= prod[m][n];
    };
    // the next panel (C = 0) to Qt, transposed
    for (int R = warp; R < nR; R += nwarps) {
      T acc[4][4];
      update(R, 0, acc);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const T col[4] = {acc[0][n], acc[1][n], acc[2][n], acc[3][n]};
        st4(Qt + (4 * tx + n) * ldq + 16 * R + 4 * ty, col);
      }
    }
    __syncthreads();
    if (warp == 0) {
      factor_diag_block(Qt, ldq, Lit, Dv, Wb, s + kPanel, min(kPanel, t), cp,
                        ldw);
    } else {
      for (int e = warp - 1; e < nR * (nC - 1); e += nwarps - 1) {
        const int R = e / (nC - 1), C = 1 + e % (nC - 1);
        if (32 * C > 16 * R + 15) continue;
        T acc[4][4];
        update(R, C, acc);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (16 * R + 4 * ty + m < t)
            st4(A22 + (long long)(16 * R + 4 * ty + m) * ldw + 32 * C
                    + 4 * tx, acc[m]);
      }
    }
    __syncthreads();
  }
}

// Below rows r0 .. r0 + kRT of task b solved in place in shared memory X
// (kRT x (ldw + 1)), 32 columns at a time, against the factor in the
// workspace Wb (w live columns, nbl live below rows), then written out as
// out = X - Bm on the live rows and columns, 0 elsewhere (Bm and out in
// the layout of lay):
//   Upper = false: X M^T = Bm, M lower: its tiles below the diagonal read
//     transposed from rows s.., X_s = acc Minv_ss^T with Minv_ss at rows
//     inv.. (Cholesky's L11; LU's unit L11);
//   Upper = true: X M = Bm, M upper: its tiles above the diagonal read as
//     stored from rows k0.., X_s = acc Minv_ss (LU's U11).
template <typename T, bool Upper, typename Lay>
__device__ void below_tile(const T* __restrict__ Bm, T* __restrict__ out,
                           const T* __restrict__ Wb, T* Lt, T* X, int b,
                           Lay lay, int ldw, int w, int nbl, int r0,
                           int inv) {
  const int tid = threadIdx.x, ldx = ldw + 1, cp = lay.cp, rbp = lay.rbp;
  const int rows = min(kRT, rbp - r0);
  const int nrows = max(0, min(rows, nbl - r0));
  if (nrows > 0 && w > 0) {
    batched<T>(kRT, ldw, [&](int, int r, int c) {
      const long long f = (long long)(r0 + r) * cp + c;
      return (r < nrows && c < w) ? Bm[lay.below(f, b)] : T(0);
    }, [&](int, int r, int c, T v) { X[r * ldx + c] = v; });
    const int tx = tid % 8, ty = tid / 8;  // columns 4tx.., rows ty, ty + 16
    constexpr int kPer = kPanel * kPanel / kRowThreads;
    // a 32 x 32 tile of the workspace at (row0, col0), nr x nc of it live,
    // fetched into registers (its loads in flight during the product before
    // it) and put into Lt as Lt[k*kLdT + n] = M[k][n], the factor of the
    // product: transposed for a lower factor, as stored for an upper one
    T pre[kPer], pinv[kPer];
    auto fetch = [&](T* dst, int row0, int col0, int nr, int nc) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = tid + u * kRowThreads, j = e / kPanel, k = e % kPanel;
        dst[u] = j < nr && (!Upper || k < nc)
                     ? Wb[(long long)(row0 + j) * ldw + col0 + k] : T(0);
      }
    };
    auto put = [&](const T* src) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = tid + u * kRowThreads;
        if (Upper)
          Lt[(e / kPanel) * kLdT + e % kPanel] = src[u];
        else
          Lt[(e % kPanel) * kLdT + e / kPanel] = src[u];
      }
    };
    // M's tile for columns s.. of X and rows k0.. of the sum
    auto fetch_off = [&](int s, int k0) {
      if (Upper)
        fetch(pre, k0, s, kPanel, w - s);
      else
        fetch(pre, s, k0, w - s, kPanel);
    };
    for (int s = 0; s < w; s += kPanel) {
      fetch(pinv, inv, s, kPanel, kPanel);  // Minv_ss
      if (s > 0) fetch_off(s, 0);
      __syncthreads();                   // X staged or written back
      T acc[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          acc[m][n] = X[(ty + 16 * m) * ldx + s + 4 * tx + n];
      // acc = Bm_s - X_{<s} M[<s, s] (lower: M^T)
      for (int k0 = 0; k0 < s; k0 += kPanel) {
        put(pre);
        __syncthreads();
        if (k0 + kPanel < s) fetch_off(s, k0 + kPanel);
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          const T x0 = X[ty * ldx + k0 + k];
          const T x1 = X[(ty + 16) * ldx + k0 + k];
          T v[4];
          ld4(Lt + k * kLdT + 4 * tx, v);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            acc[0][n] -= x0 * v[n];
            acc[1][n] -= x1 * v[n];
          }
        }
        __syncthreads();
      }
      // X_s = acc Minv_ss (lower: Minv_ss^T)
      put(pinv);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          X[(ty + 16 * m) * ldx + s + 4 * tx + n] = acc[m][n];
      __syncthreads();
      T y[2][4] = {};
#pragma unroll 8
      for (int k = 0; k < kPanel; ++k) {
        const T x0 = X[ty * ldx + s + k];
        const T x1 = X[(ty + 16) * ldx + s + k];
        T v[4];
        ld4(Lt + k * kLdT + 4 * tx, v);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          y[0][n] += x0 * v[n];
          y[1][n] += x1 * v[n];
        }
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          X[(ty + 16 * m) * ldx + s + 4 * tx + n] = y[m][n];
    }
    __syncthreads();
  }
  // out (element e = r*cp + c of the tile at o0 + e of the task's block)
  const long long o0 = (long long)r0 * cp;
  batched<T>(rows, cp, [&](int e, int r, int c) {
    return (r < nrows && c < w) ? X[r * ldx + c] - Bm[lay.below(o0 + e, b)]
                                : T(0);
  }, [&](int e, int, int, T v) { out[lay.below(o0 + e, b)] = v; });
}

// Block (task b, y): for y < ceil(rbp / kRT), below rows r0 .. r0 + kRT:
// X L11^T = B (below_tile); past them, rows of dd = L11 - D, kRT at a time
// (many SMs share the copy that one would take long over)
template <typename T, typename Lay>
__device__ __forceinline__ void chol_below(const int* __restrict__ widths,
                                           const int* __restrict__ nbelow,
                                           const T* __restrict__ D,
                                           const T* __restrict__ Bm,
                                           T* __restrict__ dd,
                                           T* __restrict__ db,
                                           const T* __restrict__ W, Lay lay,
                                           int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Lt = reinterpret_cast<T*>(smem);    // (32 x kLdT) a tile of L11 or
                                         // Linv, transposed
  T* X = Lt + kPanel * kLdT;             // (kRT x ldw + 1) rows of B, then X
  const int b = blockIdx.x, cp = lay.cp, rbp = lay.rbp;
  const int w = clampi(widths[b], cp);
  const T* Wb = W + (long long)b * (cp + kPanel) * ldw;
  const int nbt = (rbp + kRT - 1) / kRT;
  if ((int)blockIdx.y >= nbt) {
    // dd (element e = i*cp + c of the rows i0.. at o0 + e of the window)
    const int i0 = (blockIdx.y - nbt) * kRT;
    const long long o0 = (long long)i0 * cp;
    batched<T>(min(kRT, cp - i0), cp, [&](int e, int r, int c) {
      const int i = i0 + r;
      if (i >= w || c >= w) return T(0);
      return (c <= i ? Wb[(long long)i * ldw + c] : T(0))
             - D[lay.diag(o0 + e, b)];
    }, [&](int e, int, int, T v) { dd[lay.diag(o0 + e, b)] = v; });
    return;
  }
  below_tile<T, false>(Bm, db, Wb, Lt, X, b, lay, ldw, w,
                       clampi(nbelow[b], rbp), blockIdx.y * kRT, cp);
}

// ---------------------------------------------------------------------------
// LU; workspace W (B, cp + 64, ldw) as in the header
// ---------------------------------------------------------------------------

// warps 0 and 1 of the thread block meet here (named barrier 1)
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// Warps 0 and 1: factor the diagonal block staged in Dg (Dg[i*kLdD + c]
// holds A[s+i][s+c]; pw live columns, the identity past them) without
// pivoting, as getrf_inv.cu does. Warp 0 eliminates, overwrites Dg with the
// combined factor (L strictly below the diagonal, U on and above it) and
// writes its live part to rows s.. of Wb; then warp 0 forms Linv, to Lit
// (Lit[k*kLdT + i] = Linv[i][k]) and rows cp.. of Wb, while warp 1 forms
// Uinv, to Ui (Ui[k*kLdT + j] = Uinv[k][j]) and rows cp + 32.. of Wb (Dv:
// 1 / U's diagonal).
template <typename T>
__device__ void lu_factor_diag_block(T* Dg, T* Lit, T* Ui, T* Dv, T* Wb,
                                     int s, int pw, int cp, int ldw) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp == 0) {
    T a[kPanel];                  // lane i: row i of the block
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      a[c] = lane < pw ? (c < pw ? Dg[lane * kLdD + c] : T(0))
                       : (c == lane ? T(1) : T(0));
    // right-looking elimination; after step k, lane i > k holds L[i][k] in
    // a[k], and lane k holds U's row k in a[k..]
#pragma unroll
    for (int k = 0; k + 1 < kPanel; ++k) {
      const T piv = __shfl_sync(kFull, a[k], k);       // U[k][k]
      const T lcol = a[k] / piv;
#pragma unroll
      for (int j = k + 1; j < kPanel; ++j) {
        const T ukj = __shfl_sync(kFull, a[j], k);     // U[k][j]
        if (lane > k) a[j] -= lcol * ukj;
      }
      if (lane > k) a[k] = lcol;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kPanel; ++c) Dg[lane * kLdD + c] = a[c];
    __syncwarp();
    if (lane < pw)
      for (int r = 0; r < pw; ++r)
        Wb[(long long)(s + r) * ldw + s + lane] = Dg[r * kLdD + lane];
  }
  pair_sync();
  if (warp == 0) {
    // Linv, unit forward substitution, four partial sums; lane j: column j
    T x[kPanel];
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      T acc[4] = {};
#pragma unroll
      for (int k = 0; k < i; ++k) acc[k % 4] += Dg[i * kLdD + k] * x[k];
      x[i] = (i == lane ? T(1) : T(0))
             - ((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      Lit[lane * kLdT + i] = x[i];
      Wb[(long long)(cp + i) * ldw + s + lane] = x[i];
    }
  } else {
    Dv[lane] = T(1) / Dg[lane * kLdD + lane];
    __syncwarp();
    // Y = (U^T)^{-1}, forward substitution, four partial sums; lane j:
    // column j of Y, which is row j of Uinv
    T y[kPanel];
#pragma unroll
    for (int i = 0; i < kPanel; ++i) {
      T acc[4] = {};
#pragma unroll
      for (int k = 0; k < i; ++k) acc[k % 4] += Dg[k * kLdD + i] * y[k];
      y[i] = ((i == lane ? T(1) : T(0))
              - ((acc[0] + acc[1]) + (acc[2] + acc[3]))) * Dv[i];
    }
#pragma unroll
    for (int i = 0; i < kPanel; ++i) Ui[lane * kLdT + i] = y[i];
    __syncwarp();
#pragma unroll 8
    for (int k = 0; k < kPanel; ++k)
      Wb[(long long)(cp + kPanel + k) * ldw + s + lane] = Ui[k * kLdT + lane];
  }
}

// f32 keeps two pairs of panel buffers in shared memory, so that the
// trailing update writes the next step's panels straight into the second
// pair; f64 at cp 256 has room for one pair, so its trailing update writes
// them to the workspace and the next step stages them from there
template <typename T>
__host__ __device__ constexpr bool lu_double_buffered() {
  return sizeof(T) == 4;
}

// The body of lu_diag_*: one thread block per task.
template <typename T, typename Lay>
__device__ __forceinline__ void lu_diag(const int* __restrict__ widths,
                                        const T* __restrict__ DL,
                                        const T* __restrict__ DU,
                                        T* __restrict__ W, Lay lay,
                                        int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kTwo = lu_double_buffered<T>();
  const int ldp = ldw + 4;               // rows of Pt, staged transposed
  T* Pt = reinterpret_cast<T*>(smem);    // (32 x ldp) the block column below
                                         // the diagonal block, transposed
  T* Ur = Pt + kPanel * ldp;             // (32 x ldw) the block row right of
                                         // it
  T* Lit = Ur + kPanel * ldw;            // (32 x kLdT) Linv, transposed
  T* Ui = Lit + kPanel * kLdT;           // (32 x kLdT) Uinv
  T* Dg = Ui + kPanel * kLdT;            // (32 x kLdD) the diagonal block
  T* Dv = Dg + kPanel * kLdD;            // (32) 1 / U's diagonal
  T* Pn = kTwo ? Dv + kPanel : Pt;       // the next step's Pt and Ur
  T* Un = kTwo ? Pn + kPanel * ldp : Ur;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int cp = lay.cp, w = clampi(widths[b], cp);
  T* Wb = W + (long long)b * (cp + 2 * kPanel) * ldw;
  if (w == 0) return;
  // A[i][c] of the working matrix of step s (i, c < w): the front, DL on and
  // below the diagonal and DU^T above it, at s = 0; the workspace after it
  auto at = [&](int s, int i, int c) {
    if (s > 0) return Wb[(long long)i * ldw + c];
    return c <= i ? DL[lay.diag((long long)i * cp + c, b)]
                  : DU[lay.diag((long long)c * cp + i, b)];
  };
  const int pw0 = min(kPanel, w);
  batched<T>(kPanel, kPanel, [&](int, int i, int c) {
    return i < pw0 && c < pw0 ? at(0, i, c) : T(0);
  }, [&](int, int i, int c, T v) { Dg[i * kLdD + c] = v; });
  __syncthreads();
  if (warp < 2) lu_factor_diag_block(Dg, Lit, Ui, Dv, Wb, 0, pw0, cp, ldw);
  __syncthreads();
  // right-looking over 32-column blocks, one block ahead: warps 0 and 1
  // factor the next diagonal block while the others update the rest of the
  // trailing square
  for (int s = 0; s + kPanel < w; s += kPanel) {
    const int t = w - s - kPanel;        // rows and columns past the block
    const int nL = (t + 15) / 16, nC = (t + 31) / 32;
    if (!kTwo || s == 0) {
      // stage, zero past t, the block column A_is to Pt (transposed, 16 nL
      // rows) and the block row A_si to Ur (32 nC columns), as rows of 32
      // values in one copy loop
      batched<T>(16 * nL + 32 * nC, kPanel, [&](int, int r, int c) {
        if (r < 16 * nL)
          return r < t ? at(s, s + kPanel + r, s + c) : T(0);
        r -= 16 * nL;
        const int j = r / kPanel * kPanel + c;
        return j < t ? at(s, s + r % kPanel, s + kPanel + j) : T(0);
      }, [&](int, int r, int c, T v) {
        if (r < 16 * nL) {
          Pt[c * ldp + r] = v;
        } else {
          r -= 16 * nL;
          Ur[(r % kPanel) * ldw + r / kPanel * kPanel + c] = v;
        }
      });
      __syncthreads();
    }
    // the panels, in place, and to Wb: L_is = A_is Uinv by warp tiles of 16
    // rows x 32 columns, U_si = Linv A_si by warp tiles of 32 rows x 16
    // columns (a warp reads and overwrites its own rows, or columns)
    for (int e = warp; e < nL + 2 * nC; e += nwarps) {
      T acc[4][4] = {};
      if (e < nL) {
        const int ty = lane / 8, tx = lane % 8, i0 = 16 * e + 4 * ty;
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          T u[4], v[4];
          ld4(Pt + k * ldp + i0, u);
          ld4(Ui + k * kLdT + 4 * tx, v);
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n) acc[m][n] += u[m] * v[n];
        }
        __syncwarp();
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (i0 + m < t)
            st4(Wb + (long long)(s + kPanel + i0 + m) * ldw + s + 4 * tx,
                acc[m]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const T col[4] = {acc[0][n], acc[1][n], acc[2][n], acc[3][n]};
          st4(Pt + (4 * tx + n) * ldp + i0, col);
        }
      } else {
        const int ty = lane / 4, tx = lane % 4;
        const int j0 = 16 * (e - nL) + 4 * tx;
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          T u[4], v[4];
          ld4(Lit + k * kLdT + 4 * ty, u);
          ld4(Ur + k * ldw + j0, v);
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n) acc[m][n] += u[m] * v[n];
        }
        __syncwarp();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (j0 < t)
            st4(Wb + (long long)(s + 4 * ty + m) * ldw + s + kPanel + j0,
                acc[m]);
          st4(Ur + (4 * ty + m) * ldw + j0, acc[m]);
        }
      }
    }
    __syncthreads();
    // trailing update A22 -= L_is U_si by warp tiles of 16 rows x 32
    // columns, rows 16R + 4ty + m, columns 32C + 4tx + n
    const int ty = lane / 8, tx = lane % 8;
    // tile q of the trailing square: the next diagonal block's two, (R, C) =
    // (0, 0) and (1, 0), are q = -2 and -1; the rest count from 0
    auto tile = [&](int q, int& R, int& C) {
      if (q < 0) {
        R = q + 2;
        C = 0;
        return;
      }
      int e = q + 1;
      if (nL > 1 && e >= nC) ++e;
      R = e / nC;
      C = e % nC;
    };
    // tile q updated: its old values (0 past t) minus the product, to Dg
    // (the next diagonal block), to Pn and Un (the next step's panels) when
    // double-buffered, else back to Wb
    auto update = [&](int q) {
      int R, C;
      tile(q, R, C);
      const int i0 = 16 * R + 4 * ty, j = 32 * C + 4 * tx;
      T acc[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          acc[m][n] = i0 + m < t && j + n < t
                          ? at(s, s + kPanel + i0 + m, s + kPanel + j + n)
                          : T(0);
      T prod[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < kPanel; ++k) {
        T u[4], v[4];
        ld4(Pt + k * ldp + 16 * R + 4 * ty, u);
        ld4(Ur + k * ldw + 32 * C + 4 * tx, v);
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) prod[m][n] += u[m] * v[n];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] -= prod[m][n];
      if (q < 0) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) Dg[(i0 + m) * kLdD + j + n] = acc[m][n];
      } else if (kTwo && C == 0) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const T col[4] = {acc[0][n], acc[1][n], acc[2][n], acc[3][n]};
          st4(Pn + (j + n) * ldp + i0 - kPanel, col);
        }
      } else if (kTwo && R < 2) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          st4(Un + (i0 + m) * ldw + j - kPanel, acc[m]);
      } else if (j < t) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (i0 + m < t)
            st4(Wb + (long long)(s + kPanel + i0 + m) * ldw + s + kPanel + j,
                acc[m]);
      }
    };
    // warps 0 and 1: the next diagonal block, then they factor it; the
    // others: the rest
    const int nrest = nL * nC - min(nL, 2);
    if (warp < 2 || warp - 2 < nrest) update(warp - 2);
    __syncthreads();
    if (warp < 2) {
      lu_factor_diag_block(Dg, Lit, Ui, Dv, Wb, s + kPanel, min(kPanel, t),
                           cp, ldw);
    } else {
      for (int q = warp - 2 + nwarps - 2; q < nrest; q += nwarps - 2)
        update(q);
    }
    __syncthreads();
    if (kTwo) {
      T* p = Pt;
      Pt = Pn;
      Pn = p;
      p = Ur;
      Ur = Un;
      Un = p;
    }
  }
}

// Block (task b, y): below rows of BL (y < nbt) or of BU (nbt <= y < 2 nbt)
// solved by below_tile, X U11 = BL and X L11^T = BU; past them, rows of ddl
// = L11 - DL, then of ddu = U11^T - DU, kRT at a time
template <typename T, typename Lay>
__device__ __forceinline__ void lu_below(
    const int* __restrict__ widths, const int* __restrict__ nbelow,
    const T* __restrict__ DL, const T* __restrict__ DU,
    const T* __restrict__ BL, const T* __restrict__ BU, T* __restrict__ ddl,
    T* __restrict__ ddu, T* __restrict__ dbl, T* __restrict__ dbu,
    const T* __restrict__ W, Lay lay, int ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Lt = reinterpret_cast<T*>(smem);    // (32 x kLdT) a tile of the factor
  T* X = Lt + kPanel * kLdT;             // (kRT x ldx) rows of X, or of U11^T
  const int ldx = ldw + 1;
  const int b = blockIdx.x, cp = lay.cp, rbp = lay.rbp;
  const int w = clampi(widths[b], cp);
  const T* Wb = W + (long long)b * (cp + 2 * kPanel) * ldw;
  const int nbt = (rbp + kRT - 1) / kRT, ncb = (cp + kRT - 1) / kRT;
  const int y = blockIdx.y;
  if (y < nbt) {
    below_tile<T, true>(BL, dbl, Wb, Lt, X, b, lay, ldw, w,
                        clampi(nbelow[b], rbp), y * kRT, cp + kPanel);
    return;
  }
  if (y < 2 * nbt) {
    below_tile<T, false>(BU, dbu, Wb, Lt, X, b, lay, ldw, w,
                         clampi(nbelow[b], rbp), (y - nbt) * kRT, cp);
    return;
  }
  // element e = i*cp + c of the rows i0.. of ddl or ddu at o0 + e
  const int yd = y - 2 * nbt;
  const int i0 = (yd % ncb) * kRT;
  const long long o0 = (long long)i0 * cp;
  const int rows = min(kRT, cp - i0);
  if (yd < ncb) {
    batched<T>(rows, cp, [&](int e, int r, int c) {
      const int i = i0 + r;
      if (i >= w || c >= w) return T(0);
      return (c < i ? Wb[(long long)i * ldw + c] : T(c == i ? 1 : 0))
             - DL[lay.diag(o0 + e, b)];
    }, [&](int e, int, int, T v) { ddl[lay.diag(o0 + e, b)] = v; });
    return;
  }
  // U11^T's rows i0.. are U11's columns: X[j*ldx + c] = U11[c][i0 + j]
  if (w > i0) {
    batched<T>(w, kRT, [&](int, int c, int j) {
      return Wb[(long long)c * ldw + i0 + j];
    }, [&](int, int c, int j, T v) { X[j * ldx + c] = v; });
    __syncthreads();
  }
  batched<T>(rows, cp, [&](int e, int r, int c) {
    const int i = i0 + r;
    if (i >= w || c >= w) return T(0);
    return (c <= i ? X[r * ldx + c] : T(0)) - DU[lay.diag(o0 + e, b)];
  }, [&](int e, int, int, T v) { ddu[lay.diag(o0 + e, b)] = v; });
}

// Allow a kernel the dynamic shared memory it takes beyond 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
size_t chol_diag_smem(int ldw) {
  return (size_t)kPanel * (2 * ldw + 4 + kLdT + 1) * sizeof(T);
}

template <typename T>
size_t lu_diag_smem(int ldw) {
  return (size_t)kPanel * ((lu_double_buffered<T>() ? 2 : 1) * (2 * ldw + 4)
                           + 2 * kLdT + kLdD + 1) * sizeof(T);
}

template <typename T>
size_t below_smem(int ldw) {
  return ((size_t)kRT * (ldw + 1) + (size_t)kPanel * kLdT) * sizeof(T);
}

// The two launches of one call of layout Lay: diag and below are that
// layout's __global__ wrappers of chol_diag and chol_below. A static in a
// template is one per instantiation, so each layout's kernels get their
// shared-memory limit raised once, before any graph capture.
template <typename T, typename Lay, typename Diag, typename Below>
int chol_launch(Diag diag, Below below, const void* widths,
                const void* nbelow, const void* D, const void* Bm, void* dd,
                void* db, void* ws, int B, int cp, int rbp, void* stream) {
  if (cp < 1 || cp > kMaxCp || B < 0 || rbp < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  static bool smem_allowed = false;
  cudaError_t e;
  if (!smem_allowed) {
    e = allow_smem(diag, chol_diag_smem<T>(kMaxCp));
    if (e == cudaSuccess) e = allow_smem(below, below_smem<T>(kMaxCp));
    if (e != cudaSuccess) return (int)e;
    smem_allowed = true;
  }
  const int ldw = (cp + kPanel - 1) / kPanel * kPanel;
  const Lay lay{B, cp, rbp};
  diag<<<(unsigned)B, panel_diag_threads<T>(), chol_diag_smem<T>(ldw),
         st>>>((const int*)widths, (const T*)D, (T*)ws, lay, ldw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)B,
                  (unsigned)((rbp + kRT - 1) / kRT + (cp + kRT - 1) / kRT));
  below<<<grid, kRowThreads, below_smem<T>(ldw), st>>>(
      (const int*)widths, (const int*)nbelow, (const T*)D, (const T*)Bm,
      (T*)dd, (T*)db, (const T*)ws, lay, ldw);
  return (int)cudaGetLastError();
}

// The same for LU: diag and below wrap lu_diag and lu_below.
template <typename T, typename Lay, typename Diag, typename Below>
int lu_launch(Diag diag, Below below, const void* widths, const void* nbelow,
              const void* DL, const void* DU, const void* BL, const void* BU,
              void* ddl, void* ddu, void* dbl, void* dbu, void* ws, int B,
              int cp, int rbp, void* stream) {
  if (cp < 1 || cp > kMaxCp || B < 0 || rbp < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  static bool smem_allowed = false;
  cudaError_t e;
  if (!smem_allowed) {
    e = allow_smem(diag, lu_diag_smem<T>(kMaxCp));
    if (e == cudaSuccess) e = allow_smem(below, below_smem<T>(kMaxCp));
    if (e != cudaSuccess) return (int)e;
    smem_allowed = true;
  }
  const int ldw = (cp + kPanel - 1) / kPanel * kPanel;
  const Lay lay{B, cp, rbp};
  diag<<<(unsigned)B, panel_diag_threads<T>(), lu_diag_smem<T>(ldw), st>>>(
      (const int*)widths, (const T*)DL, (const T*)DU, (T*)ws, lay, ldw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // runs for rbp == 0 too: it writes ddl and ddu
  const dim3 grid((unsigned)B, (unsigned)(2 * ((rbp + kRT - 1) / kRT)
                                          + 2 * ((cp + kRT - 1) / kRT)));
  below<<<grid, kRowThreads, below_smem<T>(ldw), st>>>(
      (const int*)widths, (const int*)nbelow, (const T*)DL, (const T*)DU,
      (const T*)BL, (const T*)BU, (T*)ddl, (T*)ddu, (T*)dbl, (T*)dbu,
      (const T*)ws, lay, ldw);
  return (int)cudaGetLastError();
}

}  // namespace
