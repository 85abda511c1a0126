"""Probe ``lu_panel_deltas_lanes`` on the card, one call of it at a time.

    python -m spfx_torch.bench.lu_lanes_probe check
    python -m spfx_torch.bench.lu_lanes_probe profile
    python -m spfx_torch.bench.lu_lanes_probe variants [VARIANTS [SHAPES
        [FAMILY]]]

- ``check``: the kernel against its plain version at seeded shapes that
  cross its 32-column blocks and 32-row tiles (f32 tolerance 1e-4, f64
  1e-12, of the largest plain output), and its time at (cp, rbp, B) =
  (256, 2560, 1), the 48^3 LU plan's heaviest call;
- ``profile``: per-launch device times under torch.profiler of the kernel
  (its two launches) and of the library calls, ``lu_factor_ex(pivot=False)``
  + two ``solve_triangular``, at three shapes;
- ``variants``: copies of ``csrc/panel_lanes.cu`` (or, with FAMILY
  ``wide``, ``csrc/panel_wide.cu``) and the header it includes,
  ``csrc/panel_blocks.cuh``, with parts edited out or replaced (each edit
  in whichever file holds its text), each copy built with nvcc and timed
  at SHAPES: a Python literal of (B, cp, rbp) triples, or ``plan``, the
  48^3 LU plan's four PC buckets with the most tasks, with their widths
  and nbelow. VARIANTS is a file holding a Python literal list of (name,
  [(old text, new text), ...]); without it (or with ``-``), the parts of
  the diagonal phase are cut one at a time (their outputs are then wrong:
  the point is the time each part holds the call).

Inputs are diagonally dominant unsymmetric fronts made from numpy
``default_rng(1)``, as the CPU tests make them. Times are CUDA-graph
replays between CUDA events (``time_ms``). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ast
import ctypes
import statistics
import sys

import numpy as np
import torch

from spfx_torch.kernels import _cuda, panel_lanes

CHECK_SHAPES = [(1, 256, 2561, [255], [2500]), (2, 256, 0, [256, 131], [0, 0]),
                (1, 160, 33, [160], [33]), (2, 96, 70, [0, 96], [0, 70]),
                (3, 70, 45, [70, 33, 1], [45, 0, 44]), (1, 40, 5, [17], [3]),
                (2, 64, 64, [64, 64], [64, 30]),
                (1, 256, 2560, [256], [2560]),
                (64, 256, 300, [256] * 64, [300] * 64)]
PROFILE_SHAPES = [(1, 256, 2560), (8, 256, 512), (64, 128, 300)]
CUTS = [("full", []),
        ("no factorization in the loop",
         [("      lu_factor_diag_block(Dg, Lit, Ui, Dv, Wb, s + kPanel, "
           "min(kPanel, t),\n", "      if (0) lu_factor_diag_block(Dg, Lit, "
           "Ui, Dv, Wb, s + kPanel, min(kPanel, t),\n")]),
        ("no rest of the trailing update",
         [("        update(q);\n", "        ;\n")]),
        ("no panels", [("for (int e = warp; e < nL + 2 * nC; e += nwarps)",
                        "for (int e = warp; e < 0; e += nwarps)")]),
        ("below phase only",
         [("  diag<<<(unsigned)B, panel_diag_threads<T>(), lu_",
           "  if (0) diag<<<(unsigned)B, panel_diag_threads<T>(), lu_")])]


def lu_inputs(B: int, cp: int, rbp: int, widths=None, nbelow=None):
    """(widths, nbelow, DL, DU, BL, BU), task-major numpy arrays."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((B, cp, cp))
    A += (np.abs(A).sum(axis=2)[..., None] + 1.0) * np.eye(cp)[None]
    junk = np.triu(np.full((cp, cp), 5.0), 1)[None]
    DL = np.tril(A) + junk
    DU = np.tril(np.swapaxes(A, 1, 2), -1) + junk + 3.0 * np.eye(cp)[None]
    BL = rng.standard_normal((B, rbp, cp))
    BU = rng.standard_normal((B, rbp, cp))
    w = np.array(widths if widths is not None else [cp] * B, np.int32)
    nb = np.array(nbelow if nbelow is not None else [rbp] * B, np.int32)
    return w, nb, DL, DU, BL, BU


def on_card(B, cp, rbp, dtype, widths=None, nbelow=None, lanes=True):
    """(widths, nbelow, [DL, DU, BL, BU]) on the card, in lanes layout or
    task-major."""
    dev = torch.device("cuda")
    w, nb, *blks = lu_inputs(B, cp, rbp, widths, nbelow)
    if lanes:
        blks = [np.ascontiguousarray(np.transpose(b, (1, 2, 0)))
                for b in blks]
    return (torch.from_numpy(w).to(dev), torch.from_numpy(nb).to(dev),
            [torch.from_numpy(b).to(dev, dtype) for b in blks])


def plan_calls(grid: int = 48, top: int = 4):
    """(B, cp, rbp, widths, nbelow) of the ``top`` PC buckets with the most
    tasks in the LU plan of laplacian_3d(grid)."""
    import spfx_torch
    from spfx_torch.io import generate
    plan = spfx_torch.LU(generate.laplacian_3d(grid), device="cuda").plan
    calls = [(len(pb.widths), pb.cp, pb.rbp, list(pb.widths),
              list(pb.nbelow)) for lp in plan.levels for pb in lp.panels]
    return sorted(calls, key=lambda c: -c[0])[:top]


def time_ms(fn, reps: int = 10, rounds: int = 7) -> float:
    """Median device time of one call: ``reps`` calls in one CUDA graph,
    replayed ``rounds`` times between CUDA events."""
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def check() -> bool:
    ok = True
    for B, cp, rbp, ws, nbs in CHECK_SHAPES:
        for td in (torch.float32, torch.float64):
            w, nb, ins = on_card(B, cp, rbp, td, ws, nbs)
            outs = panel_lanes.lu_panel_deltas_lanes(w, nb, *ins, cp, rbp)
            ref = panel_lanes.lu_panel_deltas_lanes_plain(w, nb, *ins, cp,
                                                          rbp)
            torch.cuda.synchronize()
            scale = max(max((float(r.abs().max()) for r in ref
                             if r.numel()), default=0.0), 1.0)
            err = max(float((o - r).abs().max()) if r.numel() else 0.0
                      for o, r in zip(outs, ref))
            tol = (1e-4 if td == torch.float32 else 1e-12) * scale
            good = err <= tol and all(bool(torch.isfinite(o).all())
                                      for o in outs)
            ok &= good
            line = (f"{td} (cp {cp}, rbp {rbp}, B {B}) err {err:.3e} tol "
                    f"{tol:.3e} {'OK' if good else 'FAIL'}")
            if td == torch.float32 and (cp, rbp, B) == (256, 2560, 1):
                line += " time ms %.4f" % time_ms(
                    lambda: panel_lanes.lu_panel_deltas_lanes(
                        w, nb, *ins, cp, rbp))
            print(line, flush=True)
    return ok


def profile() -> bool:
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for B, cp, rbp in PROFILE_SHAPES:
        w, nb, ins = on_card(B, cp, rbp, torch.float32)
        DL, DU, BL, BU = (t.permute(2, 0, 1) for t in ins)
        i = torch.arange(cp, device=w.device)
        D = torch.where(i[:, None] >= i[None, :], DL, DU.transpose(1, 2))
        BL, BU = BL.contiguous(), BU.contiguous()

        def library():
            LU, _, _ = torch.linalg.lu_factor_ex(D, pivot=False)
            return (torch.linalg.solve_triangular(LU, BL, upper=True,
                                                  left=False),
                    torch.linalg.solve_triangular(
                        LU.mT, BU, upper=True, left=False,
                        unitriangular=True))

        for name, fn in (("kernel", lambda: panel_lanes.lu_panel_deltas_lanes(
                w, nb, *ins, cp, rbp)), ("library", library)):
            fn()
            torch.cuda.synchronize()
            with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total]
            total = sum(e.self_device_time_total for e in ev) / 20 / 1e3
            print(f"(B {B}, cp {cp}, rbp {rbp}) {name}: device ms per call "
                  f"{total:.4f}", flush=True)
            for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
                print(f"    {e.key[:80]:80s} "
                      f"{e.self_device_time_total / 20 / 1e3:.4f} ms",
                      flush=True)
    return True


def variants(spec=None, shapes=None, family="lanes") -> bool:
    from spfx_torch.bench.kernel_probe import build
    todo = CUTS if spec in (None, "-") else \
        ast.literal_eval(open(spec).read())
    if shapes == "plan":
        shapes = plan_calls()
    elif shapes is None:
        shapes = PROFILE_SHAPES
    else:
        shapes = ast.literal_eval(shapes)
    libs = []
    for name, lib in build(f"panel_{family}.cu", todo):
        fn = getattr(lib, f"spfx_lu_panel_{family}_f32")
        fn.argtypes = _cuda._PANEL_LU
        fn.restype = ctypes.c_int
        libs.append((name, fn))
    for B, cp, rbp, *counts in shapes:
        w, nb, ins = on_card(B, cp, rbp, torch.float32, *counts,
                             lanes=family == "lanes")
        outs = [torch.empty_like(t) for t in ins]
        ws = torch.empty((B, cp + 64, -(-cp // 32) * 32), device=w.device)
        for name, fn in libs:
            def call(fn=fn):
                rc = fn(w.data_ptr(), nb.data_ptr(),
                        *(t.data_ptr() for t in (*ins, *outs, ws)), B, cp,
                        rbp, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {name!r}: CUDA error {rc}")
            print(f"(B {B}, cp {cp}, rbp {rbp}) {name}: "
                  f"{time_ms(call):.4f} ms", flush=True)
    return True


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("lu_lanes_probe: no CUDA device", file=sys.stderr)
        return 2
    _cuda.build()
    mode = argv[0] if argv else "check"
    ok = {"check": check, "profile": profile,
          "variants": lambda: variants(*argv[1:4])}[mode]()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
