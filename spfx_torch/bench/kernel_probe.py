"""Probe ``getrf_inv`` and ``syrk_gemm_batched`` on the card: where a
launch's time goes, by timing copies of the kernel's source with parts cut
out.

    python -m spfx_torch.bench.kernel_probe getrf [plan] [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe syrk [SOURCE ...]
    python -m spfx_torch.bench.kernel_probe div

- ``getrf``: device time per launch of ``getrf_inv`` at B = 1, 12, 64 and
  256 seeded blocks of nb = 32 (every block of full width), f32 and f64,
  whole and with its parts cut (``GETRF_CUTS``: the two inverses, one of
  them, everything but the staging and the stores); with ``plan``, in f32
  on the 48^3 LU plan's own blocks instead (mostly narrower than 32): the
  first block of its largest call, that call, and all of its calls in
  one graph;
- ``syrk``: device time per launch of ``syrk_gemm_batched`` on its fast
  path at the panel bench's size (2^16 items, n = m = 64, k = 32, f32),
  whole and with its products, its stores or its loads cut
  (``SYRK_CUTS``);
- ``div``: the f32 division that ``getrf_inv`` takes (``quot`` in
  csrc/getrf_inv.cu) against the card's IEEE division, bit for bit over
  2^26 seeded operand pairs of each of ``DIV_RANGES`` (counting the pairs
  it leaves to the IEEE division), and the time of one step of a chain
  of dependent divisions: IEEE with a nonzero and with a zero numerator,
  and the fast form.

Each copy is the kernel's source under ``csrc/`` with text edits, built
with nvcc (all copies at once) and loaded with ctypes; a cut copy's
outputs are wrong, the point is the time each part holds a launch. The
whole copy is first checked against the plain version (getrf: 1e-4 f32,
1e-12 f64 of the largest plain output; syrk: 1e-5). Further SOURCE files
(another version of the same kernel, say the parent commit's) are built
and timed whole beside it, in the same process, so two designs are
compared on one card. Times are CUDA-graph replays between CUDA events
(``lu_lanes_probe.time_ms``). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
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

# the same for csrc/syrk_gemm.cu, its fast (bulk) path
SYRK_CUTS = [
    ("whole", []),
    ("no products", [("kProducts = true", "kProducts = false")]),
    ("no stores", [("kStores = true", "kStores = false")]),
    ("loads replaced by a constant", [("kLoads = true", "kLoads = false")]),
]


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


def getrf(extra=(), plan=False) -> bool:
    dev = torch.device("cuda")
    if plan:
        import spfx_torch
        from spfx_torch.io import generate
        calls = plan_getrf_calls(
            spfx_torch.LU(generate.laplacian_3d(48), device=dev), dev)
        wrel, D = max(calls, key=lambda c: c[0].shape[0])
        cases = {torch.float32: [
            (f"48^3 plan's largest call, first block (w {int(wrel[0])})",
             [(wrel[:1].contiguous(), D[:1].contiguous())]),
            (f"48^3 plan's largest call (B {wrel.shape[0]})", [(wrel, D)]),
            (f"48^3 plan's {len(calls)} calls", calls)]}
    else:
        cases = {td: [(f"B {B}", [getrf_inputs(B, td)])
                      for B in GETRF_BATCHES]
                 for td in (torch.float32, torch.float64)}
    libs = build("getrf_inv.cu", GETRF_CUTS, extra)
    ok = True
    for td, tcases in cases.items():
        t = "f32" if td == torch.float32 else "f64"
        fns = [(name, entry(lib, [f"spfx_getrf_inv_{t}"],
                            _cuda._SIGNATURES["getrf_inv"][
                                f"spfx_getrf_inv_{t}"]))
               for name, lib in libs]
        for label, calls in tcases:
            calls = [(w, d.to(td)) for w, d in calls]
            outs = [[torch.empty_like(d) for _ in range(4)] for _, d in calls]
            for k, (name, fn) in enumerate(fns):
                def run(fn=fn):
                    for (w, d), o in zip(calls, outs):
                        rc = fn(w.data_ptr(), d.data_ptr(),
                                *(x.data_ptr() for x in o), d.shape[0],
                                d.shape[1], stream())
                        if rc:
                            raise RuntimeError(f"{name!r}: CUDA error {rc}")
                line = f"getrf {t} {label} {name}: "
                if name == "whole" or k >= len(GETRF_CUTS):
                    run()
                    torch.cuda.synchronize()
                    err, tol = 0.0, 0.0
                    for (w, d), o in zip(calls, outs):
                        refs = panel.getrf_inv_plain(w, d)
                        scale = max(max(float(r.abs().max()) for r in refs),
                                    1.0)
                        e = max(float((x - r).abs().max())
                                for x, r in zip(o, refs))
                        lim = (1e-4 if td == torch.float32 else 1e-12) * scale
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from spfx_torch.chol.factorize import matmul_precision
    mode = argv[0] if argv else "getrf"
    rest = argv[1:]
    with matmul_precision("highest"):
        if mode == "getrf" and rest[:1] == ["plan"]:
            ok = getrf(rest[1:], plan=True)
        else:
            ok = {"getrf": getrf, "syrk": syrk, "div": div}[mode](rest)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
