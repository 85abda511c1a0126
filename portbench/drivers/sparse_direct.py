"""Sparse direct factorizations and solves through the program's public
entry points: ``spfx_torch.Cholesky`` / ``spfx_torch.LU`` (one context a
pattern), ``ctx.factorize(A)`` and ``factor.solve(B)``.

The mix's ``op`` names the request:

- ``"factorize"``: request i factorizes a fresh matrix object holding value
  set i mod ``pool``; its answer is the factor, judged by
  ``reference.factor_backward_error``;
- ``"solve"``: one factorization at set-up, of the family's middle value
  set (the same for every seed, so that the seed does not change the
  refinement's sweeps); request i solves
  the block of ``nrhs`` right-hand sides i mod ``pool`` with the config's
  refinement; its answer is the solution, judged by
  ``reference.scaled_residual``, and so is the request's first pass on the
  device (the unrefined solve, before float64 refinement can hide a
  factor or a solve of a lower precision).

Value sets and right-hand sides are drawn from the seed at set-up, on the
host. A reservoir of ``sample`` answers, drawn from the seed, is kept
through the window and judged once it has closed.

With spans on (the traced run), wrappers set on the program's instances
time the calls into its layers: the context's ``entry_values``, the
runner's ``run`` (CUDA events on the card) and the factor's
``_solve_device`` (one pass of a refined solve), each inside a
``torch.profiler.record_function`` of the layer's name.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import reference, spec


class Cell:
    def __init__(self, config: dict, mix: dict, seed: int, device,
                 spans: bool = False, roots=None):
        self.config = config
        self.mix = mix
        self.device = torch.device(device)
        self.spans = spans
        self.lu = config["kind"] == "lu"
        self.family = spec.load_module(
            "families", config["family"], roots).Family(config)
        self.seed = seed
        self.ctx = None
        self.factor = None

    # -- inputs ---------------------------------------------------------

    def _draw(self, seed: int) -> None:
        """The value sets, right-hand sides and sampling stream of
        ``seed``; clears the requests' records and the sample."""
        vals, rhs, pick, probe = np.random.SeedSequence(
            [abs(seed), int(seed < 0)]).spawn(4)
        pool = self.mix["pool"]
        self.values = self.family.values(np.random.default_rng(vals), pool)
        self.rhs = []
        if self.mix["op"] == "solve":
            g = np.random.default_rng(rhs)
            self.rhs = [g.standard_normal((self.family.n, self.mix["nrhs"]))
                        for _ in range(pool)]
        self.pick = np.random.default_rng(pick)
        self.probe_seed = int(np.random.default_rng(probe).integers(2**31))
        self.sample = []            # (request, answer)
        self.seen = 0
        self.records = []           # one dict a request

    def matrix(self, i: int):
        return self.family.matrix(self.values[i % len(self.values)])

    def solved(self):
        """The matrix the solve mix factors."""
        return self.family.matrix(self.family.middle())

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        """The context (host analysis and plan), then the warm requests
        that build every kernel and capture every graph this mix uses."""
        import spfx_torch
        self._draw(self.seed)
        cfg = spfx_torch.Config(**self.config["program_config"])
        kind = spfx_torch.LU if self.lu else spfx_torch.Cholesky
        self.ctx = kind(self.solved(), cfg, device=self.device)
        self._warm()

    def reseed(self, seed: int) -> None:
        """The inputs of another seed on the same context (the reading of
        many seeds in one process, without spans); the solve mix factors
        again."""
        if self.spans:
            raise ValueError("reseed: a cell with spans runs one seed")
        self.seed = seed
        self._draw(seed)
        # the last factor's solve graphs are freed here, not by a collection
        # during the next capture (the wrappers hold it in a cycle)
        self.factor = self.first = None
        gc.collect()
        self._warm()

    def _warm(self) -> None:
        if self.mix["op"] == "solve":
            self.factor = self.ctx.factorize(self.solved())
            self._keep_first_pass()
            for w in range(self.mix["warm"]):
                self.factor.solve(self.rhs[w % len(self.rhs)])
        else:
            for w in range(self.mix["warm"]):
                self.ctx.factorize(self.matrix(w))
        self._sync()
        if self.spans:
            self._wrap()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep_first_pass(self) -> None:
        """Keep the first ``_solve_device`` pass of each solve request (a
        reference to its result) for the check."""
        pass_fn = self.factor._solve_device

        def solve_device(*a, **k):
            out = pass_fn(*a, **k)
            if self.first is None:
                self.first = out
            return out

        self.first = None
        self.factor._solve_device = solve_device

    # -- spans ----------------------------------------------------------

    def _wrap(self) -> None:
        """Wrappers on the program's instances, recording into the current
        request's record."""
        ctx = self.ctx
        ev_fn, run_fn = ctx.entry_values, ctx._runner.run

        def entry_values(*a, **k):
            t0 = time.perf_counter()
            with record_function("entry_values"):
                out = ev_fn(*a, **k)
            self.rec["entry_values_s"] = time.perf_counter() - t0
            return out

        def run(*a, **k):
            cuda = self.device.type == "cuda"
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            with record_function("replay"):
                out = run_fn(*a, **k)
            if cuda:
                e1.record()
                self.rec["replay_events"] = (e0, e1)
            return out

        ctx.entry_values, ctx._runner.run = entry_values, run
        if self.factor is not None:
            f = self.factor
            pass_fn = f._solve_device

            def solve_device(*a, **k):
                t0 = time.perf_counter()
                with record_function("solve_pass"):
                    out = pass_fn(*a, **k)
                self.rec.setdefault("pass_s", []).append(
                    time.perf_counter() - t0)
                return out

            f._solve_device = solve_device

    # -- requests -------------------------------------------------------

    def request(self, i: int, profiled: bool = False) -> None:
        """Request i, to its end: the factor or the solution is on the
        host's side of a synchronize when it returns."""
        self.rec = {"i": i, "profiled": profiled}
        if self.mix["op"] == "solve":
            self.first = None
            with record_function("refine"):
                x = self.factor.solve(self.rhs[i % len(self.rhs)])
            answer = (x, self.first)
        else:
            with record_function("factorize"):
                answer = self.ctx.factorize(self.matrix(i))
        self.records.append(self.rec)
        self._keep(i, answer)

    def _keep(self, i: int, answer) -> None:
        """Reservoir sampling of the answers, from the seed's stream."""
        k = self.mix["sample"]
        if self.seen < k:
            self.sample.append((i, answer))
        else:
            j = int(self.pick.integers(0, self.seen + 1))
            if j < k:
                self.sample[j] = (i, answer)
        self.seen += 1

    # -- after the window -----------------------------------------------

    def observations(self) -> dict:
        """What the metric readers read: the requests' records (the CUDA
        events resolved into ms), the plan and the factor arrays' dtype."""
        self._sync()
        recs = []
        for r in self.records:
            r = dict(r)
            ev = r.pop("replay_events", None)
            if ev is not None:
                r["replay_ms"] = ev[0].elapsed_time(ev[1])
            recs.append(r)
        return {"records": recs, "plan": self.ctx.plan,
                "dtype": self.config["program_config"].get("dtype",
                                                           "float32"),
                "arrays": 2 if self.lu else 1}

    def check(self) -> dict:
        """{name: value} of the sampled answers against the reference; the
        limits are the configuration's."""
        if self.mix["op"] == "solve":
            A = self.solved()
            got = [[reference.scaled_residual(A, x, self.rhs[i % len(
                self.rhs)]) for x in answer] for i, answer in self.sample]
            return {"solve_residual": float(np.max([g[0] for g in got])),
                    "pass_residual": float(np.max([g[1] for g in got]))}
        from spfx_torch.chol.factorize import lower_entries
        # the program's own map of its flat arrays (what L_sparse() and
        # LU_sparse() read them by), to read the factors' values
        rows, cols, pos = lower_entries(self.ctx.sym, self.ctx.plan)
        errs = []
        for i, f in self.sample:
            if self.lu:
                lh, uh = f.host_factors()
                lv, uv = lh[pos], uh[pos]
            else:
                lv, uv = f.host_factor()[pos], None
            errs.append(reference.factor_backward_error(
                self.matrix(i), f.sym.perm, rows, cols, lv, uv,
                seed=self.probe_seed))
        # np.max keeps a NaN, which then fails its limit
        return {"factor_backward_error": float(np.max(errs))}

    def release(self) -> None:
        """Drop the sample and the context."""
        self.sample = []
        self.factor = self.ctx = None
