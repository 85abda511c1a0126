"""Probe ``getrf_inv``, ``potrf_inv``, ``getrf_inv_c``, ``potrf_inv_c``,
``bmm_bf16x3``, ``extend_add_rows``, ``syrk_gemm_batched`` and
``cholesky_small_batched`` on the card: where a launch's time goes, by
timing copies of the kernel's source with parts cut out.

    python -m spfx_torch.bench.kernel_probe getrf|potrf|getrf_c|potrf_c
        [plan] [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe bf16x3 [plan] [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe bf16x3 copy [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe extend [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe syrk [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe chol_small [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe div

- ``getrf`` and ``potrf``: device time per launch of ``getrf_inv`` or
  ``potrf_inv`` at B = 1, 12, 64 and 256 seeded blocks of nb = 32 (every
  block of full width), f32 and f64, whole and with its parts cut
  (``GETRF_CUTS``: the two inverses, one of them, everything but the
  staging and the stores; ``POTRF_CUTS``: the inverse, everything but the
  staging and the stores); with ``plan``, in f32 on the 48^3 plan's own
  blocks instead (LU for getrf, Cholesky for potrf; mostly narrower than
  32): one launch at B = 1 on the plan's widest block (``widest_block``:
  a launch's floor is its widest block's path), its largest call, and
  all of its calls in one graph;
- ``getrf_c``: the same for ``getrf_inv_c`` (csrc/getrf_inv_c.cu) in
  complex64 and complex128, seeded complex blocks (``GETRF_C_CUTS``, the
  cuts of ``GETRF_CUTS``); with ``plan``, on the complex64 48^3 LU plan's
  own blocks (the unsymmetric magnetic Laplacian, ``magnetic_laplacian``),
  in both types;
- ``potrf_c``: the same for ``potrf_inv_c`` (csrc/potrf_inv_c.cu),
  seeded Hermitian blocks (``POTRF_C_CUTS``, the cuts of ``POTRF_CUTS``);
  with ``plan``, on the complex64 48^3 Cholesky plan's own blocks (the
  magnetic Laplacian), in both types;
- ``bf16x3``: device time of ``bmm_bf16x3``'s kernel at
  ``BF16X3_SHAPES`` (the 48^3 plan's largest UT product and two common
  ones), whole and with its loads, split, products or stores cut
  (``BF16X3_CUTS``), beside full-float32 ``torch.bmm`` and the bound;
  with ``plan``, at the 48^3 Cholesky plan's largest UT product and over
  all of its products in one graph (``ut_product_shapes``, operands from
  ``bmm_operands``). A SOURCE without the entry of today's kernel (the
  parent's) is timed through its ``ANY_STRIDES`` entry;
- ``bf16x3 copy``: the products that ``bmm_bf16x3`` copies into its
  kernel's layout first, in one factorization and one device solve of the
  48^3 Laplacian in f32 under ``matmul_precision="high"``, Cholesky and
  LU (``copy_calls``: the walks' own views), all in one graph: through
  ``matmul.bmm_bf16x3`` (one copy of each operand that does not fit,
  then the kernel), through each SOURCE as it reads them (the parent's
  any-strides kernel), and by full-float32 ``torch.bmm``;
- ``extend``: device time of ``extend_add_rows`` in f32 at the 48^3
  Cholesky plan's largest call (over rotated copies of its slab and E
  that exceed the L2 cache), and of all of the plan's calls in one graph,
  each also with every row dropped (the table walk alone); then the LU
  path, every call on two slabs (one ``extend_add_rows2`` launch where the
  source has it, else two launches); whole and with its parts cut
  (``EXTEND_CUTS``: reductions replaced by plain stores, E's loads, the
  body), and beside them the launch floor: an empty one-block kernel per
  call, which no design can beat;
- ``syrk``: device time per launch of ``syrk_gemm_batched`` on its fast
  path at the panel bench's size (2^16 items, n = m = 64, k = 32, f32),
  whole and with its products, its stores or its loads cut
  (``SYRK_CUTS``);
- ``chol_small``: device time per launch of ``cholesky_small_batched`` at
  (batch, c) = (65,536, 32) and (65,536, 16), f32 and f64, beside each
  shape's byte bound (each lower triangle read, each factor written, over
  3.35 TB/s), whole and with its parts cut (``CHOL_SMALL_CUTS``: one
  value stored a lane in place of L, no factorization, no loads, an empty
  body at the design's grid, every column step of the row width run
  where the kernel would stop at c);
- ``div``: the f32 division that ``getrf_inv`` takes (``quot`` in
  csrc/diag_block.cuh) against the card's IEEE division, bit for bit over
  2^26 seeded operand pairs of each of ``DIV_RANGES`` (counting the pairs
  it leaves to the IEEE division), and the time of one step of a chain
  of dependent divisions: IEEE with a nonzero and with a zero numerator,
  and the fast form.

Each copy is the kernel's source under ``csrc/`` with text edits, built
with nvcc (all copies at once) and loaded with ctypes; a cut copy's
outputs are wrong, the point is the time each part holds a launch. The
whole copy is first checked against the plain version (getrf, potrf,
getrf_c, potrf_c: 1e-4 f32 and complex64, 1e-12 f64 and complex128 of the
largest plain output; bf16x3: 3 k 2^-22 of sum |a||b| per entry, as
chip_smoke.py's phase 3g; chol_small the same as getrf,
and exact zeros above the diagonal; extend: 1e-6 of the
slab's largest entry; syrk: 1e-5). Further SOURCE files (another version
of the same kernel, say the parent commit's) are built, checked and timed
whole beside it, in the same process, so two designs are compared on one
card. Times are CUDA-graph replays between CUDA events
(``lu_lanes_probe.time_ms``). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from spfx_torch.bench.lu_lanes_probe import time_ms
from spfx_torch.bench.panels import inputs as panel_inputs
from spfx_torch.kernels import _cuda, panel, syrk_gemm

CSRC = os.path.join(os.path.dirname(_cuda.__file__), "csrc")
GETRF_BATCHES = (1, 12, 64, 256)

# (name, [(old text, new text), ...]) applied to csrc/getrf_inv.cu
GETRF_CUTS = [
    ("whole", []),
    ("no Linv", [("kLinv = true", "kLinv = false")]),
    ("no Uinv", [("kUinv = true", "kUinv = false")]),
    ("no inverses", [("kLinv = true", "kLinv = false"),
                     ("kUinv = true", "kUinv = false")]),
    ("staging and stores only", [("kLinv = true", "kLinv = false"),
                                 ("kUinv = true", "kUinv = false"),
                                 ("kElim = true", "kElim = false")]),
]

# the same for csrc/getrf_inv_c.cu
GETRF_C_CUTS = [
    ("whole", []),
    ("no Linv", [("kLinvC = true", "kLinvC = false")]),
    ("no Uinv", [("kUinvC = true", "kUinvC = false")]),
    ("no inverses", [("kLinvC = true", "kLinvC = false"),
                     ("kUinvC = true", "kUinvC = false")]),
    ("staging and stores only", [("kLinvC = true", "kLinvC = false"),
                                 ("kUinvC = true", "kUinvC = false"),
                                 ("kElimC = true", "kElimC = false")]),
]

# the same for csrc/bmm_bf16x3.cu, its fast path
BF16X3_CUTS = [
    ("whole", []),
    ("no products", [("kProducts = true", "kProducts = false")]),
    ("no split", [("kSplit = true", "kSplit = false")]),
    ("no stores", [("kStores = true", "kStores = false")]),
    ("loads cut", [("kLoads = true", "kLoads = false")]),
]
# (batch, m, k, n): the 48^3 plan's largest UT product and two of its
# common ones
BF16X3_SHAPES = ((128, 132, 256, 260), (16, 144, 64, 64), (16, 64, 32, 64))

# the same for csrc/potrf_inv.cu
POTRF_CUTS = [
    ("whole", []),
    ("no inverse", [("kInv = true", "kInv = false")]),
    ("staging and stores only", [("kInv = true", "kInv = false"),
                                 ("kChol = true", "kChol = false")]),
]

# the same for csrc/potrf_inv_c.cu
POTRF_C_CUTS = [
    ("whole", []),
    ("no inverse", [("kInvC = true", "kInvC = false")]),
    ("staging and stores only", [("kInvC = true", "kInvC = false"),
                                 ("kCholC = true", "kCholC = false")]),
]

# the same for csrc/extend_add.cu; the last copy adds an empty kernel of
# one thread block, launched once per call in place of the kernel
EXTEND_ENTRY = 'extern "C" int spfx_extend_add_rows_f32('
EXTEND_FLOOR = r"""
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
EXTEND_CUTS = [
    ("whole", []),
    ("reductions replaced by plain stores",
     [("kAtomic = true", "kAtomic = false")]),
    ("E's loads cut", [("kLoadE = true", "kLoadE = false")]),
    ("empty body, the design's grid", [("kBody = true", "kBody = false")]),
    ("launch floor", [(EXTEND_ENTRY, EXTEND_FLOOR + EXTEND_ENTRY)]),
]

# the same for csrc/syrk_gemm.cu, its fast (bulk) path
SYRK_CUTS = [
    ("whole", []),
    ("no products", [("kProducts = true", "kProducts = false")]),
    ("no stores", [("kStores = true", "kStores = false")]),
    ("loads replaced by a constant", [("kLoads = true", "kLoads = false")]),
]

# the same for csrc/chol_small.cu
CHOL_SMALL_CUTS = [
    ("whole", []),
    ("one value stored a lane", [("kStore = true", "kStore = false")]),
    ("staging and stores only", [("kFactor = true", "kFactor = false")]),
    ("factorization with no loads", [("kStage = true", "kStage = false")]),
    ("empty body, the design's grid", [("kBody = true", "kBody = false")]),
    ("every column step run", [("kStopAtC = true", "kStopAtC = false")]),
]
CHOL_SMALL_SHAPES = ((65536, 32), (65536, 16))   # (batch, c)


# (biased exponent range of a, of b, share of zero numerators)
DIV_RANGES = [((0, 254), (0, 254), 0.05), ((1, 130), (120, 134), 0.2),
              ((20, 60), (110, 140), 0.0), ((60, 194), (60, 194), 0.1)]

# appended to a copy of csrc/getrf_inv.cu for ``div``
DIV_TEST = r"""
__global__ void div_exact_kernel(const unsigned* ab, unsigned long long* n3,
                                 long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = __uint_as_float(ab[2 * i]);
  const float b = __uint_as_float(ab[2 * i + 1]);
  bool off = false;
  const float q = quot<false>(a, b, rcp_nr(b), off);
  if (off)
    atomicAdd(n3 + 2, 1ull);
  else if (__float_as_uint(q) != __float_as_uint(a / b))
    atomicAdd(n3, 1ull);
}
__global__ void div_chain_kernel(float* out, float a, float b, int n,
                                 int fast) {
  float x = 0.0f;
  bool off = false;
  const float rb = rcp_nr(b);
  for (int i = 0; i < n; ++i)
    x = fast ? quot<false>(fmaf(x, 0.0f, a), b, rb, off)
             : fmaf(x, 0.0f, a) / b;
  out[threadIdx.x] = off ? -x : x;
}
extern "C" int div_exact(const void* ab, void* n3, long long n) {
  div_exact_kernel<<<(unsigned)((n + 255) / 256), 256>>>(
      (const unsigned*)ab, (unsigned long long*)n3, n);
  return (int)cudaGetLastError();
}
extern "C" int div_chain(void* out, float a, float b, int n, int fast) {
  div_chain_kernel<<<1, 32>>>((float*)out, a, b, n, fast);
  return (int)cudaGetLastError();
}
"""


def build(top: str, cuts, extra=()):
    """Build copies of ``csrc/<top>`` beside copies of every csrc header:
    one per cut, a list of (old text, new text) edits, each applied in
    whichever of those files holds its text; then each file of ``extra``
    whole. All nvcc runs start together. Returns [(name, CDLL)] and
    prints each copy's ptxas register lines."""
    files = [top] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    texts = {f: open(os.path.join(CSRC, f)).read() for f in files}
    todo = []
    for name, edits in cuts:
        t = dict(texts)
        for old, new in edits:
            hits = [f for f in t if old in t[f]]
            if not hits:
                raise ValueError(f"cut {name!r}: text not found: {old!r}")
            for f in hits:
                t[f] = t[f].replace(old, new)
        todo.append((name, t))
    todo += [(src, dict(texts, **{top: open(src).read()})) for src in extra]
    tmp = tempfile.mkdtemp()
    procs = []
    for i, (name, t) in enumerate(todo):
        vdir = os.path.join(tmp, f"v{i}")
        os.makedirs(vdir)
        for f, text in t.items():
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        so = os.path.join(tmp, f"v{i}.so")
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", so,
             os.path.join(vdir, top)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name!r} does not build:\n{log}")
        regs = " | ".join(line.split(":")[-1].strip()
                          for line in log.splitlines() if "registers" in line)
        print(f"[build] {name}: {regs}", flush=True)
        out.append((name, ctypes.CDLL(so)))
    return out


def entry(lib, names, argtypes):
    """The first of ``names`` that ``lib`` exports, typed."""
    for n in names:
        if hasattr(lib, n):
            fn = getattr(lib, n)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            return fn
    raise AttributeError(f"none of {names} in {lib}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def getrf_inputs(B: int, dtype):
    """(wrel, D): seeded diagonally dominant (B, 32, 32) blocks, both
    triangles filled, every block of full width."""
    rng = np.random.default_rng(B)
    D = rng.standard_normal((B, 32, 32))
    D += (np.abs(D).sum(axis=2)[..., None] + 1.0) * np.eye(32)[None]
    dev = torch.device("cuda")
    return (torch.full((B,), 32, dtype=torch.int32, device=dev),
            torch.from_numpy(D).to(dev, dtype))


def getrf_c_inputs(B: int, dtype):
    """(wrel, D): seeded diagonally dominant complex (B, 32, 32) blocks,
    both triangles filled, every block of full width."""
    rng = np.random.default_rng(B)
    D = rng.standard_normal((B, 32, 32)) + 1j * rng.standard_normal(
        (B, 32, 32))
    D += (np.abs(D).sum(axis=2)[..., None] + 1.0) * np.eye(32)[None]
    dev = torch.device("cuda")
    return (torch.full((B,), 32, dtype=torch.int32, device=dev),
            torch.from_numpy(D).to(dev, dtype))


def potrf_inputs(B: int, dtype):
    """(wrel, D): seeded SPD (B, 32, 32) blocks X X^T + 32 I with junk
    above the diagonal (never read), every block of full width."""
    rng = np.random.default_rng(B)
    X = rng.standard_normal((B, 32, 32))
    D = X @ np.swapaxes(X, 1, 2) + 32.0 * np.eye(32)[None]
    D += np.triu(rng.standard_normal((B, 32, 32)) * 100.0, 1)
    dev = torch.device("cuda")
    return (torch.full((B,), 32, dtype=torch.int32, device=dev),
            torch.from_numpy(D).to(dev, dtype))


def potrf_c_inputs(B: int, dtype):
    """(wrel, D): seeded Hermitian positive definite complex (B, 32, 32)
    blocks X X^H + 32 I with junk above the diagonal (never read), every
    block of full width."""
    rng = np.random.default_rng(B)
    X = rng.standard_normal((B, 32, 32)) + 1j * rng.standard_normal(
        (B, 32, 32))
    D = X @ np.conj(np.swapaxes(X, 1, 2)) + 32.0 * np.eye(32)[None]
    D += np.triu(rng.standard_normal((B, 32, 32)) * 100.0, 1)
    dev = torch.device("cuda")
    return (torch.full((B,), 32, dtype=torch.int32, device=dev),
            torch.from_numpy(D).to(dev, dtype))


def widest_block(calls):
    """(wrel, D) of one block at B = 1: the first block of the greatest
    live width among the diagonal-block calls ``calls``."""
    widths = [int(w.clamp(0, d.shape[1]).max()) for w, d in calls]
    w, d = calls[widths.index(max(widths))]
    i = int(w.clamp(0, d.shape[1]).argmax())
    return w[i:i + 1].contiguous(), d[i:i + 1].contiguous()


def plan_getrf_calls(ctx, dev):
    """(wrel, D) of every getrf_inv call of the LU plan of ``ctx`` (an
    ``spfx_torch.LU``): the 32 x 32 diagonal blocks of each PC bucket's LU
    front, built from the assembled (not yet factored) Lx and Ux."""
    from spfx_torch.kernels import blocks
    plan = ctx.plan
    Lx, Ux = (blocks.assemble(torch.as_tensor(idx, device=dev), v,
                              plan.storage)
              for idx, v in zip((plan.assembly_idx, plan.assembly_idx_u),
                                ctx.entry_values(ctx.A)))
    out = []
    for lp in plan.levels:
        for pb in lp.panels:
            widths = pb.to_u(dev)[0]
            B, cp, rbp = widths.shape[0], pb.cp, pb.rbp
            lo = int(pb.slab_lo[0])
            bl, bu = (x[lo:lo + B * (cp + rbp) * cp].view(B, cp + rbp, cp)
                      for x in (Lx, Ux))
            Mf, _ = blocks.lu_front(bl[:, :cp], bu[:, :cp], widths)
            for s in range(0, cp, blocks.NB):
                e = min(s + blocks.NB, cp)
                wrel = (widths - s).clamp(0, e - s).to(torch.int32)
                out.append((wrel, Mf[:, s:e, s:e].contiguous()))
    return out


def plan_potrf_calls(ctx, dev):
    """(wrel, D) of every potrf_inv call of the Cholesky plan of ``ctx``
    (an ``spfx_torch.Cholesky``): the 32 x 32 diagonal blocks of each PC
    bucket, taken from the assembled (not yet factored) matrix."""
    from spfx_torch.kernels import blocks
    plan = ctx.plan
    L = blocks.assemble(torch.as_tensor(plan.assembly_idx, device=dev),
                        ctx.entry_values(ctx.A), plan.storage)
    out = []
    for lp in plan.levels:
        for pb in lp.panels:
            widths = pb.to_u(dev)[0]
            B, cp, rbp = widths.shape[0], pb.cp, pb.rbp
            lo = int(pb.slab_lo[0])
            blk = L[lo:lo + B * (cp + rbp) * cp].view(B, cp + rbp, cp)
            for s in range(0, cp, blocks.NB):
                e = min(s + blocks.NB, cp)
                wrel = (widths - s).clamp(0, e - s).to(torch.int32)
                out.append((wrel, blk[:, s:e, s:e].contiguous()))
    return out


def unsym_laplacian(k: int):
    """laplacian_3d(k) with every entry above the diagonal scaled by a
    factor from U[0.25, 1] (numpy default_rng(0)): unsymmetric values on a
    symmetric pattern, so swapped L and U sides would show."""
    import numpy as np
    import scipy.sparse as sp
    from spfx_torch.io import generate
    A = generate.laplacian_3d(k)
    up = sp.triu(A, 1).tocoo()
    up.data = up.data * np.random.default_rng(0).uniform(0.25, 1.0, up.nnz)
    return sp.csc_matrix(sp.tril(A) + up)

def magnetic_laplacian(k: int, unsym: bool = False):
    """laplacian_3d(k) with each off-diagonal pair -1 / -1 made
    -e^{i theta} above the diagonal and -e^{-i theta} below it, theta from
    U[0, 2 pi) (numpy default_rng(0)): a Hermitian matrix with the
    Laplacian's diagonal, still diagonally dominant, so positive definite.
    With ``unsym``, every entry above the diagonal then scaled by
    ``unsym_laplacian``'s factors from U[0.25, 1] (a fresh default_rng(0)):
    complex unsymmetric values on the symmetric pattern."""
    import numpy as np
    import scipy.sparse as sp
    from spfx_torch.io import generate
    A = generate.laplacian_3d(k)
    up = sp.triu(A, 1).tocoo()
    theta = np.random.default_rng(0).uniform(0.0, 2 * np.pi, up.nnz)
    vals = up.data * np.exp(1j * theta)
    U = sp.coo_matrix((vals, (up.row, up.col)), shape=A.shape)
    low = U.conj().T
    if unsym:
        U = sp.coo_matrix((vals * np.random.default_rng(0).uniform(
            0.25, 1.0, up.nnz), (up.row, up.col)), shape=A.shape)
    return sp.csc_matrix(sp.diags(A.diagonal().astype(np.complex128))
                         + U + low)

def ut_product_shapes(plan):
    """(batch, m, k, n) of the product C = G H^T of every UT step: G the
    (mp + ALIGN/kp)-row source superwindows, H the head windows."""
    from spfx_torch.plan.schedule import ALIGN
    return [(len(ub.kw), ub.mp + ALIGN // ub.kp, ub.kp, ub.tgt_cpos.shape[1])
            for lp in plan.levels for ub in lp.updates
            if getattr(ub, "head_start", None) is not None]

def bmm_operands(shape, gen, dev):
    """Seeded float32 operands of one UT product: G (batch, m, k) and the
    transposed view H^T (batch, k, n) that the step passes, values spread
    over 2^20 in scale by row."""
    import torch
    batch, m, k, n = shape
    G = torch.randn(batch, m, k, generator=gen, device=dev)
    G = G * torch.exp2(torch.randint(-10, 10, (batch, m, 1), generator=gen,
                                     device=dev).float())
    H = torch.randn(batch, n, k, generator=gen, device=dev)
    return G, H.transpose(1, 2)


def plan_context(name: str, dev):
    """The 48^3 plan context of a ``diag`` kind: Cholesky or LU of
    laplacian_3d(48) in f32, or the complex64 Cholesky of the magnetic
    Laplacian (``magnetic_laplacian``) or LU of its unsymmetric variant,
    as chip_smoke.py's phase 3f builds them."""
    import spfx_torch
    from spfx_torch import Config
    from spfx_torch.io import generate
    if name == "LU_c64":
        return spfx_torch.LU(magnetic_laplacian(48, unsym=True),
                             Config(dtype="complex64"), device=dev)
    if name == "Cholesky_c64":
        return spfx_torch.Cholesky(magnetic_laplacian(48),
                                   Config(dtype="complex64"), device=dev)
    return getattr(spfx_torch, name)(generate.laplacian_3d(48), device=dev)


# kind: (source, entry point prefix, cuts, outputs, plain version, seeded
# inputs, plan calls, plan context, (dtype, entry suffix) pairs)
REAL = ((torch.float32, "f32"), (torch.float64, "f64"))
COMPLEX = ((torch.complex64, "c64"), (torch.complex128, "c128"))
DIAG = {"getrf": ("getrf_inv.cu", "spfx_getrf_inv_", GETRF_CUTS, 4,
                  "getrf_inv_plain", getrf_inputs, plan_getrf_calls, "LU",
                  REAL),
        "potrf": ("potrf_inv.cu", "spfx_potrf_inv_", POTRF_CUTS, 2,
                  "potrf_inv_plain", potrf_inputs, plan_potrf_calls,
                  "Cholesky", REAL),
        "getrf_c": ("getrf_inv_c.cu", "spfx_getrf_inv_", GETRF_C_CUTS, 4,
                    "getrf_inv_plain", getrf_c_inputs, plan_getrf_calls,
                    "LU_c64", COMPLEX),
        "potrf_c": ("potrf_inv_c.cu", "spfx_potrf_inv_", POTRF_C_CUTS, 2,
                    "potrf_inv_plain", potrf_c_inputs, plan_potrf_calls,
                    "Cholesky_c64", COMPLEX)}


def diag(kind: str, extra=(), plan=False) -> bool:
    """The ``getrf``, ``potrf``, ``getrf_c`` and ``potrf_c`` modes (see the
    module docstring)."""
    src, prefix, cuts, nout, plain_name, make_inputs, plan_calls, ctx_name, \
        types = DIAG[kind]
    plain = getattr(panel, plain_name)
    dev = torch.device("cuda")
    if plan:
        calls = plan_calls(plan_context(ctx_name, dev), dev)
        wrel, D = max(calls, key=lambda c: c[0].shape[0])
        w1, D1 = widest_block(calls)
        cases = {td: [
            (f"48^3 plan's widest block, B 1 (w {int(w1[0])})",
             [(w1, D1)]),
            (f"48^3 plan's largest call (B {wrel.shape[0]})", [(wrel, D)]),
            (f"48^3 plan's {len(calls)} calls", calls)]
            for td, _ in types}
    else:
        cases = {td: [(f"B {B}", [make_inputs(B, td)])
                      for B in GETRF_BATCHES]
                 for td, _ in types}
    libs = build(src, cuts, extra)
    sigs = _cuda._SIGNATURES[src[:-3]]
    ok = True
    for td, t in types:
        fns = [(name, entry(lib, [prefix + t], sigs[prefix + t]))
               for name, lib in libs]
        single = td in (torch.float32, torch.complex64)
        for label, calls in cases[td]:
            calls = [(w, d.to(td)) for w, d in calls]
            outs = [[torch.empty_like(d) for _ in range(nout)]
                    for _, d in calls]
            for k, (name, fn) in enumerate(fns):
                def run(fn=fn):
                    for (w, d), o in zip(calls, outs):
                        rc = fn(w.data_ptr(), d.data_ptr(),
                                *(x.data_ptr() for x in o), d.shape[0],
                                d.shape[1], stream())
                        if rc:
                            raise RuntimeError(f"{name!r}: CUDA error {rc}")
                line = f"{kind} {t} {label} {name}: "
                if name == "whole" or k >= len(cuts):
                    run()
                    torch.cuda.synchronize()
                    err, tol = 0.0, 0.0
                    for (w, d), o in zip(calls, outs):
                        refs = plain(w, d)
                        scale = max(max(float(r.abs().max()) for r in refs),
                                    1.0)
                        e = max(float((x - r).abs().max())
                                for x, r in zip(o, refs))
                        lim = (1e-4 if single else 1e-12) * scale
                        ok &= e <= lim
                        err, tol = max(err, e), max(tol, lim)
                    line += (f"err {err:.3e} tol {tol:.3e} "
                             f"{'OK' if err <= tol else 'FAIL'}, ")
                if len(calls) == 1:
                    line += (f"{time_ms(run, reps=20) * 1e3:.2f} us per "
                             "launch")
                else:
                    line += (f"{time_ms(run, reps=1, rounds=3):.3f} ms in "
                             "one graph")
                print(line, flush=True)
    return ok


# the entry point of bmm_bf16x3.cu before its redesign, whose kernel read
# A and B at any strides: (A, A's 3 strides, B, B's 3 strides, C, batch,
# m, n, k, stream)
ANY_STRIDES = ("spfx_bmm_bf16x3_f32",
               [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
               + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def bf16x3_call(lib, name: str, G, Ht, C):
    """A callable that computes C = bf16x3(G @ Ht) with ``lib``: its entry
    at matmul.fast_tile's tile where it has it (G and Ht must then fit as
    they lie), else an older source's ``ANY_STRIDES`` entry."""
    from spfx_torch.kernels import matmul
    batch, m, k = G.shape
    n = Ht.shape[2]
    if hasattr(lib, "spfx_bmm_bf16x3_fast_f32"):
        if matmul.path(G, Ht) != "fast":
            raise ValueError("the operands are not read as they lie")
        fn = entry(lib, ["spfx_bmm_bf16x3_fast_f32"],
                   _cuda._SIGNATURES["bmm_bf16x3"]["spfx_bmm_bf16x3_fast_f32"])
        args = (G.data_ptr(), G.stride(0), G.stride(1), Ht.data_ptr(),
                Ht.stride(0), Ht.stride(2), C.data_ptr(), batch, m, n, k,
                *matmul.fast_tile(batch, m, n))
    else:
        fn = entry(lib, [ANY_STRIDES[0]], ANY_STRIDES[1])
        args = (G.data_ptr(), *G.stride(), Ht.data_ptr(), *Ht.stride(),
                C.data_ptr(), batch, m, n, k)

    def call():
        rc = fn(*args, stream())
        if rc:
            raise RuntimeError(f"{name!r}: CUDA error {rc}")
    return call


def bf16x3_bound_ms(shapes) -> float:
    """The larger of the products' bytes (operands read once, C written
    once) over the memory rate and their 3 x 2 m n k operations over the
    bf16 tensor-core peak (989 TFLOP/s, H100 SXM data sheet)."""
    nbytes = sum(4.0 * b * (m * k + k * n + m * n) for b, m, k, n in shapes)
    ops = sum(6.0 * b * m * n * k for b, m, k, n in shapes)
    return max(nbytes / 3.35e12, ops / 989e12) * 1e3


def bf16x3(extra=(), plan=False) -> bool:
    """The ``bf16x3`` mode (see the module docstring)."""
    from spfx_torch.kernels import matmul
    dev = torch.device("cuda")
    if plan:
        shapes = ut_product_shapes(plan_context("Cholesky", dev).plan)
        big = max(shapes, key=lambda s: s[0] * s[1] * s[2] * s[3])
        cases = [(f"48^3 plan's largest product {big}", [big]),
                 (f"48^3 plan's {len(shapes)} products", shapes)]
    else:
        cases = [(f"{s}", [s]) for s in BF16X3_SHAPES]
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    libs = build("bmm_bf16x3.cu", BF16X3_CUTS, extra)
    ok = True
    for label, shapes in cases:
        ops = [bmm_operands(s, gen, dev) for s in shapes]
        outs = [G.new_empty((G.shape[0], G.shape[1], Ht.shape[2]))
                for G, Ht in ops]
        print(f"bf16x3 {label}: bound {bf16x3_bound_ms(shapes):.4f} ms",
              flush=True)
        for k, (name, lib) in enumerate(libs):
            calls = [bf16x3_call(lib, name, G, Ht, C)
                     for (G, Ht), C in zip(ops, outs)]

            def run(calls=calls):
                for c in calls:
                    c()
            line = f"bf16x3 {label} {name}: "
            if name == "whole" or k >= len(BF16X3_CUTS):
                run()
                torch.cuda.synchronize()
                good = True
                for (G, Ht), C, s in zip(ops, outs, shapes):
                    ref = matmul.bmm_bf16x3_plain(G, Ht)
                    S = torch.bmm(G.abs().double(), Ht.abs().double())
                    d = (C - ref).abs().double()
                    good &= bool((d <= 3 * s[2] * 2.0 ** -22 * S).all())
                ok &= good
                line += f"{'OK' if good else 'FAIL'}, "
            if len(calls) == 1:
                line += f"{time_ms(run, reps=20):.4f} ms"
            else:
                line += f"{time_ms(run, reps=1, rounds=3):.3f} ms in one graph"
            print(line, flush=True)

        def library():
            for (G, Ht), C in zip(ops, outs):
                torch.bmm(G, Ht, out=C)
        t = (time_ms(library, reps=20) if len(shapes) == 1
             else time_ms(library, reps=1, rounds=3))
        print(f"bf16x3 {label} torch.bmm, full float32: {t:.4f} ms",
              flush=True)
        del ops, outs
        torch.cuda.empty_cache()
    return ok


def copy_calls(kind: str, dev):
    """The (A, B) operand pairs of every product that bmm_bf16x3 copies
    first (``matmul.path`` "copy") in one factorization and one device
    solve of laplacian_3d(48) in f32 under matmul_precision="high"
    (``kind`` "Cholesky" or "LU"): the views the walks pass, recorded
    while the mega engine captures its graphs, so each product once."""
    import spfx_torch
    from spfx_torch import Config, synth_rhs
    from spfx_torch.io import generate
    from spfx_torch.kernels import matmul
    got, orig = [], matmul.bmm_bf16x3

    def record(a, b):
        if torch.cuda.is_current_stream_capturing() \
                and matmul.path(a, b) == "copy":
            got.append((a, b))
        return orig(a, b)
    A = generate.laplacian_3d(48)
    matmul.bmm_bf16x3 = record
    try:
        f = getattr(spfx_torch, kind.lower())(
            A, Config(matmul_precision="high", solve_backend="device"),
            device=dev)
        f.solve(synth_rhs(A))
    finally:
        matmul.bmm_bf16x3 = orig
    return got


def bf16x3_copy(extra=()) -> bool:
    """The ``bf16x3 copy`` mode (see the module docstring)."""
    from spfx_torch.kernels import matmul
    dev = torch.device("cuda")
    libs = build("bmm_bf16x3.cu", [], extra)
    ok = True
    for kind in ("Cholesky", "LU"):
        calls = copy_calls(kind, dev)
        ops = 6.0 * sum(a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
                        for a, b in calls)
        tally = {}
        for a, b in calls:
            w = {(False, True): "A", (True, False): "B"}.get(
                (matmul.fits(a), matmul.fits(b.transpose(1, 2))), "both")
            tally[w] = tally.get(w, 0) + 1
        print(f"bf16x3 copy {kind}: {len(calls)} products copied first, "
              f"{ops / 1e9:.2f} GFLOP of bf16 passes; operands copied: "
              f"{tally}", flush=True)
        outs = [a.new_empty((a.shape[0], a.shape[1], b.shape[2]))
                for a, b in calls]

        def into(call, c):
            call()
            return c
        runs = [("one copy + the kernel (matmul.bmm_bf16x3)",
                 [lambda a=a, b=b: matmul.bmm_bf16x3(a, b)
                  for a, b in calls])]
        runs += [(name, [lambda f=bf16x3_call(lib, name, a, b, c), c=c:
                         into(f, c) for (a, b), c in zip(calls, outs)])
                 for name, lib in libs]
        runs.append(("torch.bmm, full float32",
                     [lambda a=a, b=b, c=c: torch.bmm(a, b, out=c)
                      for (a, b), c in zip(calls, outs)]))
        for name, fns in runs:
            def run(fns=fns):
                return [fn() for fn in fns]
            line = f"bf16x3 copy {kind} {name}: "
            if not name.startswith("torch"):
                good = True
                for (a, b), c in zip(calls, run()):
                    ref = matmul.bmm_bf16x3_plain(a, b)
                    S = torch.bmm(a.abs().double(), b.abs().double())
                    good &= bool(((c - ref).abs().double()
                                  <= 3 * a.shape[2] * 2.0 ** -22 * S).all())
                ok &= good
                line += f"{'OK' if good else 'FAIL'}, "
            print(line + f"{time_ms(run, reps=1, rounds=5):.3f} ms in one "
                  "graph", flush=True)
        del calls, outs
        torch.cuda.empty_cache()
    return ok


def plan_extend_calls(plan, dev):
    """(slab_lo, srows, csp, rows) of every UT step of the plan: the
    step's slab of the flat factor and its row table (one entry per row of
    the step's E)."""
    return [(int(ub.slab_lo[0]), ub.slab_rows, ub.csp, ub.to(dev)[6])
            for lp in plan.levels for ub in lp.updates]


def extend_add_bytes(rows, csp: int, item: int) -> float:
    """Bytes that one extend_add_rows call must move: each live row of E
    read once, each distinct slab row it names read and written once (rows
    of E that share a slab row share its traffic), plus the table."""
    live = rows[rows >= 0]
    return float((live.numel() + 2 * torch.unique(live).numel()) * csp * item
                 + 4 * rows.shape[0])


def declared_arity(text: str, fn: str) -> int:
    """The number of parameters that the source ``text`` declares for its
    extern "C" function ``fn``."""
    m = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)', text)
    if m is None:
        raise ValueError(f"no extern \"C\" {fn} in the source")
    return len(m.group(1).split(","))


def extend(extra=()) -> bool:
    """The ``extend`` mode (see the module docstring)."""
    import spfx_torch
    from spfx_torch.io import generate
    from spfx_torch.kernels import extend_add
    dev = torch.device("cuda")
    ctx = spfx_torch.Cholesky(generate.laplacian_3d(48), device=dev)
    calls = plan_extend_calls(ctx.plan, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flats = [torch.randn(ctx.plan.storage, generator=gen, device=dev)
             for _ in range(2)]
    ebufs = [torch.randn(max(r.shape[0] * cs for _, _, cs, r in calls),
                         generator=gen, device=dev) for _ in range(2)]

    def step(lo, sr, cs, r, k=0):
        return (flats[k][lo:lo + sr * cs].view(sr, cs), r,
                ebufs[k][:r.shape[0] * cs].view(-1, cs))

    path = [step(*c) for c in calls]
    dropped = [(s, torch.full_like(r, -1), e) for s, r, e in path]
    lu_path = [(step(*c), step(*c, k=1)) for c in calls]
    lo, srows, csp, rows = max(calls, key=lambda c: extend_add_bytes(
        c[3], c[2], 4))
    copies = 1 + int(2 * 50e6 // ((srows + 2 * rows.shape[0]) * csp * 4))
    big = [(flats[0][lo:lo + srows * csp].view(srows, csp).clone(), rows,
            torch.randn((rows.shape[0], csp), generator=gen, device=dev))
           for _ in range(copies)]
    big_dropped = [(s, torch.full_like(r, -1), e) for s, r, e in big]
    live = rows >= 0
    print(f"extend 48^3 plan: {len(calls)} calls, largest srows {srows} csp "
          f"{csp} RE {rows.shape[0]} live {int(live.sum())} targets "
          f"{torch.unique(rows[live]).numel()}, {copies} rotated copies",
          flush=True)
    sigs = _cuda._SIGNATURES["extend_add"]
    sig = sigs["spfx_extend_add_rows_f32"]
    libs = build("extend_add.cu", EXTEND_CUTS, extra)
    texts = [open(os.path.join(CSRC, "extend_add.cu")).read()] \
        * len(EXTEND_CUTS) + [open(src).read() for src in extra]
    ok = True
    for k, ((name, lib), text) in enumerate(zip(libs, texts)):
        # each source is called as it declares its entries: the path flag
        # where its single entry has a parameter for it (an older source
        # has none), the twin where it defines one
        vec = declared_arity(text, "spfx_extend_add_rows_f32") == len(sig)
        twin = None
        if hasattr(lib, "spfx_extend_add_rows2_f32"):
            twin = entry(lib, ["spfx_extend_add_rows2_f32"],
                         sigs["spfx_extend_add_rows2_f32"])
        fn = entry(lib, ["spfx_extend_add_rows_f32"],
                   sig if vec else sig[:6] + sig[7:])

        def flag(*ts, vec=vec):
            return (int(extend_add.vector_path(
                ts[0].shape[1], 4, [t.data_ptr() for t in ts])),) if vec \
                else ()
        per_step = "one twin launch" if twin else "two launches"
        if name == "launch floor":
            per_step = "one empty launch"
            floor = entry(lib, ["empty_launch"], [ctypes.c_void_p])

            def one(s, r, e):
                if floor(stream()):
                    raise RuntimeError("empty_launch: CUDA error")

            def two(a, b):
                one(*a)
        else:
            def one(s, r, e, fn=fn, flag=flag):
                rc = fn(s.data_ptr(), s.shape[0], s.shape[1], r.data_ptr(),
                        r.shape[0], e.data_ptr(), *flag(s, e), stream())
                if rc:
                    raise RuntimeError(f"{name!r}: CUDA error {rc}")

            def two(a, b, one=one, twin=twin):
                if twin is None:
                    one(*a)
                    one(*b)
                    return
                (sl, r, el), (su, _, eu) = a, b
                rc = twin(sl.data_ptr(), su.data_ptr(), sl.shape[0],
                          sl.shape[1], r.data_ptr(), r.shape[0],
                          el.data_ptr(), eu.data_ptr(),
                          *flag(sl, su, el, eu), stream())
                if rc:
                    raise RuntimeError(f"{name!r}: CUDA error {rc}")
        whole = name == "whole" or k >= len(EXTEND_CUTS)
        if whole:
            # every call against the plain version on a copy of its slab;
            # the twin (or the pair of calls) against two plain calls
            err = 0.0
            for (s, r, e), (b, _, f) in lu_path:
                sa, sb = s.clone(), b.clone()
                two((sa, r, e), (sb, r, f))
                ra = extend_add.extend_add_rows_plain(s.clone(), r, e)
                rb = extend_add.extend_add_rows_plain(b.clone(), r, f)
                err = max(err, float((sa - ra).abs().max()
                                     / ra.abs().max()),
                          float((sb - rb).abs().max() / rb.abs().max()))
            good = err <= 1e-6
            ok &= good
            print(f"extend f32 {name}: {len(lu_path)} calls on two slabs, "
                  f"rel err {err:.3e} {'OK' if good else 'FAIL'}",
                  flush=True)
        cases = [("largest call", big, True), ("path", path, False)]
        if whole:
            cases += [("largest call, every row dropped", big_dropped, True),
                      ("path, every row dropped", dropped, False)]
        for label, sets, single in cases:
            if single:
                it = itertools.cycle(sets)
                t = time_ms(lambda: one(*next(it)), reps=4 * len(sets))
                print(f"extend f32 {label} {name}: {t * 1e3:.2f} us per "
                      "launch", flush=True)
            else:
                def run(sets=sets):
                    for c in sets:
                        one(*c)
                t = time_ms(run, reps=1, rounds=3)
                print(f"extend f32 {label} {name}: {t:.3f} ms in one graph",
                      flush=True)

        def run_lu():
            for a, b in lu_path:
                two(a, b)
        print(f"extend f32 LU path {name}: "
              f"{time_ms(run_lu, reps=1, rounds=3):.3f} ms in one graph "
              f"({per_step} a step)",
              flush=True)
    return ok


def div(extra=()) -> bool:
    lib = build("getrf_inv.cu", [("division test", [
        ('extern "C" int spfx_getrf_inv_f32(',
         DIV_TEST + 'extern "C" int spfx_getrf_inv_f32(')])])[0][1]
    lib.div_exact.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_longlong]
    lib.div_chain.argtypes = [ctypes.c_void_p, ctypes.c_float,
                              ctypes.c_float, ctypes.c_int, ctypes.c_int]
    rng = np.random.default_rng(0)
    n = 1 << 26
    ok = True

    def floats(lo, hi):
        e = rng.integers(lo, hi + 1, n).astype(np.uint32)
        m = rng.integers(0, 1 << 23, n).astype(np.uint32)
        return (rng.integers(0, 2, n).astype(np.uint32) << 31) | (e << 23) | m

    for (alo, ahi), (blo, bhi), zeros in DIV_RANGES:
        a, b = floats(alo, ahi), floats(blo, bhi)
        a[rng.random(n) < zeros] = 0
        ab = torch.from_numpy(np.stack([a, b], 1).reshape(-1).view(np.int32))
        ab = ab.to("cuda")
        n3 = torch.zeros(3, dtype=torch.int64, device="cuda")
        if lib.div_exact(ab.data_ptr(), n3.data_ptr(), n):
            raise RuntimeError("div_exact: CUDA error")
        wrong, _, left = n3.tolist()
        ok &= wrong == 0
        print(f"div exponents a [{alo}, {ahi}] b [{blo}, {bhi}] zeros "
              f"{zeros}: {n} pairs, {left} left to the IEEE division, "
              f"{wrong} of the rest differ from it", flush=True)
    out = torch.zeros(32, device="cuda")
    steps = 100000
    for label, a, fast in (("IEEE, numerator 1.5", 1.5, 0),
                           ("IEEE, numerator 0", 0.0, 0),
                           ("fast form, numerator 1.5", 1.5, 1),
                           ("fast form, numerator 0", 0.0, 1)):
        ts = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if lib.div_chain(out.data_ptr(), a, 3.0, steps, fast):
                raise RuntimeError("div_chain: CUDA error")
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1) * 1e6 / steps)
        print(f"div chain of {steps} dependent f32 divisions, {label}: "
              f"{min(ts):.2f} ns a step", flush=True)
    return ok


def syrk(extra=()) -> bool:
    A, B = panel_inputs(device=torch.device("cuda"))
    batch, n, k = A.shape
    m = B.shape[1]
    S = A.new_empty((batch, n, n))
    G = A.new_empty((batch, m, n))
    if syrk_gemm.path(n, m, k, A.element_size(), A.data_ptr(),
                      B.data_ptr()) != "bulk":
        raise RuntimeError("the bench shape does not take the bulk path")
    sig = _cuda._SIGNATURES["syrk_gemm"]["spfx_syrk_gemm_bulk_f32"]
    libs = build("syrk_gemm.cu", SYRK_CUTS, extra)
    refs = syrk_gemm.syrk_gemm_batched_plain(A, B)
    ok = True
    for i, (name, lib) in enumerate(libs):
        fn = entry(lib, ["spfx_syrk_gemm_bulk_f32",
                         "spfx_syrk_gemm_batched_f32"], sig)

        def call(fn=fn):
            rc = fn(A.data_ptr(), B.data_ptr(), S.data_ptr(), G.data_ptr(),
                    batch, n, m, k, stream())
            if rc:
                raise RuntimeError(f"{name!r}: CUDA error {rc}")
        line = f"syrk f32 batch {batch} n {n} m {m} k {k} {name}: "
        if name == "whole" or i >= len(SYRK_CUTS):
            call()
            torch.cuda.synchronize()
            err = max(float((o - r).abs().max()) / float(r.abs().max())
                      for o, r in zip((S, G), refs))
            good = err <= 1e-5
            ok &= good
            line += f"rel err {err:.3e} {'OK' if good else 'FAIL'}, "
        line += f"{time_ms(call, reps=3, rounds=5):.4f} ms"
        print(line, flush=True)
    At = A.transpose(1, 2)
    for name, fn in (
            ("torch.bmm pair", lambda: (torch.bmm(A, At, out=S),
                                        torch.bmm(B, At, out=G))),
            # the same bytes moved with no products: A and B each read
            # once, S and G each written once
            ("two torch.cat of the same bytes",
             lambda: (torch.cat((A, A), 2, out=S),
                      torch.cat((B, B), 2, out=G)))):
        print(f"syrk f32 batch {batch} {name}: "
              f"{time_ms(fn, reps=3, rounds=5):.4f} ms", flush=True)
    return ok


def chol_small_inputs(batch: int, c: int, dtype):
    """Seeded SPD (batch, c, c) blocks X X^T + c I on the card, with junk
    above the diagonal (never read)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(batch + c)
    X = torch.randn(batch, c, c, generator=gen, device="cuda",
                    dtype=torch.float64)
    D = X @ X.transpose(1, 2) + c * torch.eye(c, device="cuda",
                                              dtype=torch.float64)
    D += torch.triu(torch.randn(batch, c, c, generator=gen, device="cuda",
                                dtype=torch.float64) * 100.0, 1)
    return D.to(dtype)


def chol_small(extra=()) -> bool:
    """The ``chol_small`` mode (see the module docstring)."""
    from spfx_torch.kernels import chol_small as cs
    libs = build("chol_small.cu", CHOL_SMALL_CUTS, extra)
    ok = True
    for td in (torch.float32, torch.float64):
        t = "f32" if td == torch.float32 else "f64"
        name_of = f"spfx_cholesky_small_batched_{t}"
        fns = [(name, entry(lib, [name_of],
                            _cuda._SIGNATURES["chol_small"][name_of]))
               for name, lib in libs]
        for batch, c in CHOL_SMALL_SHAPES:
            D = chol_small_inputs(batch, c, td)
            L = torch.empty_like(D)
            ref = cs.cholesky_small_batched_plain(D)
            tol = (1e-4 if td == torch.float32 else 1e-12) * max(
                float(ref.abs().max()), 1.0)
            bound = (batch * (c * (c + 1) / 2 + c * c) * D.element_size()
                     / 3.35e12 * 1e3)
            print(f"chol_small {t} ({batch}, {c}): bound {bound:.4f} ms "
                  "(bytes)", flush=True)
            for k, (name, fn) in enumerate(fns):
                def run(fn=fn):
                    rc = fn(D.data_ptr(), L.data_ptr(), batch, c, stream())
                    if rc:
                        raise RuntimeError(f"{name!r}: CUDA error {rc}")
                line = f"chol_small {t} ({batch}, {c}) {name}: "
                if name == "whole" or k >= len(CHOL_SMALL_CUTS):
                    L.fill_(float("nan"))
                    run()
                    torch.cuda.synchronize()
                    err = float((L - ref).abs().max())
                    good = err <= tol and bool((torch.triu(L, 1) == 0).all())
                    ok &= good
                    line += (f"err {err:.3e} tol {tol:.3e} "
                             f"{'OK' if good else 'FAIL'}, ")
                ms = time_ms(run, reps=20)
                print(line + f"{ms:.4f} ms, {bound / ms:.1%} of the bound",
                      flush=True)
            # the card's copy rate on these bytes and more: D read whole
            # and written whole
            ms = time_ms(lambda: L.copy_(D), reps=20)
            print(f"chol_small {t} ({batch}, {c}) torch copy_ of D into L "
                  f"(every value read and written): {ms:.4f} ms", flush=True)
            del D, L, ref
            torch.cuda.empty_cache()
    return ok


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from spfx_torch.kernels.mega import matmul_precision
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card or torch.cuda.get_device_name(0)}", flush=True)
    mode = argv[0] if argv else "getrf"
    rest = argv[1:]
    with matmul_precision("highest"):
        if mode in DIAG:
            plan = rest[:1] == ["plan"]
            ok = diag(mode, rest[1:] if plan else rest, plan=plan)
        elif mode == "bf16x3" and rest[:1] == ["copy"]:
            ok = bf16x3_copy(rest[1:])
        elif mode == "bf16x3":
            plan = rest[:1] == ["plan"]
            ok = bf16x3(rest[1:] if plan else rest, plan=plan)
        else:
            ok = {"extend": extend, "syrk": syrk, "chol_small": chol_small,
                  "div": div}[mode](rest)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
