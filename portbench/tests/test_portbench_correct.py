"""How ``correct`` is decided: the checks pass the program's answers,
fail the control (the reference one rung below the configuration's dtype
on the precision ladder: TF32 below float32 with TF32 off), and fail a run
whose timed path is broken underneath, once for each fault a cell can
have."""

import json

import numpy as np
import pytest
import torch

from portbench import reference, spec as specs
from portbench.tests.conftest import card

SPEC = specs.load_spec()
CONFIGS = {c["name"]: json.load(open(f"{specs.ROOT}/{c['file']}"))
           for c in SPEC["configs"]}
CELLS = [w["name"] for w in SPEC["workloads"]]


def dense_reading(conf, mantissa, grid=12, seed=11, roots=None):
    """The check's number for the dense reference factor, in the
    configuration's dtype with its trailing products at ``mantissa`` bits,
    put in the program's place, of a value set of ``conf``'s own family."""
    f = specs.load_module("families", conf["family"], roots).Family(
        dict(conf, grid=grid))
    A = f.matrix(f.values(np.random.default_rng(seed), 1)[0])
    Ad = A.toarray()
    dtype = reference.dtype_of(conf)
    r, c = np.tril_indices(A.shape[0])
    if conf["kind"] == "lu":
        L, U = reference.dense_lu(Ad, mantissa, dtype=dtype)
        lv, uv = L.numpy()[r, c], U.numpy().T[r, c]
    else:
        lv, uv = reference.dense_cholesky(Ad, mantissa, dtype=dtype).numpy()[
            r, c], None
    return reference.factor_backward_error(A, np.arange(A.shape[0]), r, c,
                                           lv, uv)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_at_own_precision_passes(name):
    conf = CONFIGS[name]
    assert dense_reading(conf, None) <= conf["limits"][
        "factor_backward_error"] / 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_control_one_rung_below_fails(name):
    conf = CONFIGS[name]
    assert dense_reading(conf, reference.rung(conf)["mantissa"]) > conf[
        "limits"]["factor_backward_error"]


def test_round_mantissa():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -3.0])
    y = reference.round_mantissa(x, 10)
    assert y.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]


def test_scaled_residual_and_permutation():
    A = torch.eye(3).numpy() * 2
    assert reference.scaled_residual(A, np.ones(3), 2 * np.ones(3)) == 0
    assert reference.scaled_residual(A, np.ones(3), np.ones(3)) == \
        pytest.approx(1 / 3)
    with pytest.raises(ValueError):
        reference.check_permutation([0, 0, 2], 3)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(run_cell, workload):
    rc, line = run_cell(workload)
    assert rc == 0 and line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert line["checks"] and all(c["value"] <= c["limit"]
                                  for c in line["checks"].values())


def _faults(mp):
    """The faults a cell can have, planted under the timed path: a step
    that returns its state unchanged, half of each batch left out, and an
    answer altered where it is produced (the exchange between chips has no
    place in a one-chip cell)."""
    from spfx_torch import CholeskyFactor, LUFactor
    from spfx_torch.kernels import mega

    def unchanged():
        mp.setattr(mega, "walk_levels", lambda *a, **k: None)
        mp.setattr(mega.MegaSolver, "forward", lambda self, F, x: x)
        mp.setattr(mega.MegaSolver, "backward", lambda self, F, x: x)

    def half():
        step, solve = mega.update_step, mega.MegaSolver.solve

        def half_step(arrays, ub, device, lu, out=None, tasks=None):
            return step(arrays, ub, device, lu, out=out,
                        tasks=(0, len(ub.kw) // 2))

        def half_solve(self, F, G, x, graphs):
            k = x.shape[1] // 2 or 1
            out = x.clone()
            out[:, :k] = solve(self, F, G, x[:, :k].contiguous(), graphs)
            return out
        mp.setattr(mega, "update_step", half_step)
        mp.setattr(mega.MegaSolver, "solve", half_solve)

    def altered():
        run = mega.MegaRunner.run

        def alter_run(self, *vals):
            out = run(self, *vals)
            first = out[0] if isinstance(out, tuple) else out
            first[0] *= 1.5            # L's first diagonal entry
            return out
        mp.setattr(mega.MegaRunner, "run", alter_run)
        for cls in (CholeskyFactor, LUFactor):
            solve = cls.solve

            def alter_solve(self, b, refine=None, _solve=solve):
                x = _solve(self, b, refine)
                x[0] += 1.0
                return x
            mp.setattr(cls, "solve", alter_solve)
    return {"unchanged": unchanged, "half": half, "altered": altered}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(run_cell, monkeypatch, workload,
                                          fault):
    _faults(monkeypatch)[fault]()
    rc, line = run_cell(workload)
    assert rc == 0 and line["correct"] is False, line


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card(workload):
    """The program one rung below on the ladder (for float32, its TF32
    path) fails the cell's check, and the program as configured passes it,
    at a grid a test run can hold."""
    card()
    from portbench.calibrate import readings
    dev = torch.device("cuda", 0)
    for side, ok in (("program", True), ("control", False)):
        for r in readings(workload, [7, 8, 9], 4, side, dev,
                          patch={"grid": 20}):
            limits = CONFIGS[SPEC_CONFIG[workload]]["limits"]
            passed = all(v <= limits[k] for k, v in r["checks"].items())
            assert passed is ok, r


SPEC_CONFIG = {w["name"]: w["config"] for w in SPEC["workloads"]}
