"""Each configuration is judged in its own arithmetic. A float64
configuration and a complex64 Hermitian one, added as new files and
entries on a copy of the spec (nothing of the package edited), run through
the harness, read ``correct: true`` as they are and ``false`` under every
planted fault, and their dense reference passes at its own precision while
its control one rung below on the ladder fails."""

import copy
import json

import numpy as np
import pytest
import torch

from portbench import bounds, reference, spec as specs
from portbench.tests.conftest import card
from portbench.tests.test_portbench_correct import _faults, dense_reading

# A frozen copy of spfx_torch/bench/kernel_probe.py's magnetic_laplacian
# (and of spfx_torch/io/generate.py's laplacian_3d), its phases drawn per
# value set from the seed
MAGLAP_FAMILY = '''"""The magnetic Laplacian: laplacian_3d(grid) with each
off-diagonal pair -1 / -1 made -e^{i theta} above the diagonal and
-e^{-i theta} below it, theta from U[0, 2 pi) per pair: Hermitian, with the
Laplacian's diagonal, diagonally dominant, so positive definite. Each value
set draws its phases from the seed; ``middle()`` draws them from
default_rng(0)."""

import numpy as np
import scipy.sparse as sp


def laplacian_1d(n):
    d = 2.0 * np.ones(n)
    e = -np.ones(n - 1)
    return sp.diags([e, d, e], [-1, 0, 1], format="csc")


def laplacian_3d(k):
    Ix = Iy = Iz = sp.identity(k)
    A = (sp.kron(Iz, sp.kron(Iy, laplacian_1d(k)))
         + sp.kron(Iz, sp.kron(laplacian_1d(k), Ix))
         + sp.kron(laplacian_1d(k), sp.kron(Iy, Ix)))
    return sp.csc_matrix(A) + 1e-2 * sp.identity(k ** 3, format="csc")


def magnetic_laplacian(k, theta):
    A = laplacian_3d(k)
    up = sp.triu(A, 1).tocoo()
    vals = up.data * np.exp(1j * theta)
    U = sp.coo_matrix((vals, (up.row, up.col)), shape=A.shape)
    low = U.conj().T
    return sp.csc_matrix(sp.diags(A.diagonal().astype(np.complex128))
                         + U + low)


class Family:
    def __init__(self, params):
        self.params = params
        self.grid = params["grid"]
        self.n = self.grid ** 3
        self.phases = sp.triu(laplacian_3d(self.grid), 1).nnz
        A = self._sorted(np.zeros(self.phases))
        self.indptr, self.indices = A.indptr, A.indices

    def _sorted(self, theta):
        A = magnetic_laplacian(self.grid, theta)
        A.sort_indices()
        return A

    def _data(self, theta):
        A = self._sorted(theta)
        if not (np.array_equal(A.indptr, self.indptr)
                and np.array_equal(A.indices, self.indices)):
            raise ValueError("the phases changed the pattern")
        return A.data

    def values(self, rng, count):
        return [self._data(rng.uniform(0.0, 2 * np.pi, self.phases))
                for _ in range(count)]

    def middle(self):
        return self._data(np.random.default_rng(0).uniform(
            0.0, 2 * np.pi, self.phases))

    def matrix(self, data):
        return sp.csc_matrix((data, self.indices, self.indptr),
                             shape=(self.n, self.n), copy=False)
'''

BASE = "poisson3d-48-chol-f32"


def fixture_configs():
    """{name: configuration} of the two fixtures. The limits lie between
    the dense reference's readings at the configuration's precision and
    one rung below (grid 12, value seed 11: float64 6.3e-16 and 1.5e-9;
    complex64 8.1e-8 and 1.5e-5)."""
    with open(f"{specs.ROOT}/portbench/configs/{BASE}.json") as fh:
        f64 = json.load(fh)
    f64 = dict(f64, name="poisson3d-48-chol-f64",
               program_config=dict(f64["program_config"], dtype="float64"),
               limits=dict(f64["limits"], factor_backward_error=1e-11))
    c64 = {"name": "maglap3d-48-chol-c64", "family": "maglap_fixture",
           "driver": "sparse_direct", "kind": "cholesky", "grid": 48,
           "program_config": {"dtype": "complex64",
                              "solve_backend": "device"},
           "limits": {"factor_backward_error": 5e-06}}
    return {c["name"]: c for c in (f64, c64)}


CONFIGS = fixture_configs()


@pytest.fixture
def room(tmp_path):
    """(roots, spec): the fixtures' family and configuration files under
    ``tmp_path``, and a copy of the spec with their entries and a
    ``.refactor`` cell each."""
    (tmp_path / "families").mkdir()
    (tmp_path / "configs").mkdir()
    (tmp_path / "families" / "maglap_fixture.py").write_text(MAGLAP_FAMILY)
    spec = copy.deepcopy(specs.load_spec())
    for name, conf in CONFIGS.items():
        path = tmp_path / "configs" / f"{name}.json"
        path.write_text(json.dumps(conf))
        spec["configs"].append({"name": name, "source": "a test fixture",
                                "file": str(path), "reduced": ["grid"],
                                "why": "a test fixture"})
        cell = f"{name}.refactor"
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": "refactor", "chips": 1,
                                  "why": "a test fixture"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if f"{BASE}.refactor" in m.get("workloads", ()):
                m["workloads"].append(cell)
    return [str(tmp_path)], spec


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fixture_cell_is_correct(run_cell, room, name):
    roots, spec = room
    rc, line = run_cell(f"{name}.refactor", roots=roots, spec=spec)
    assert rc == 0 and line["correct"] is True, line
    (key, check), = line["checks"].items()
    limit = CONFIGS[name]["limits"]["factor_backward_error"]
    assert key == "factor_backward_error" and check["limit"] == limit
    assert check["value"] <= limit / 3


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fixture_cell_broken_is_not_correct(run_cell, room, monkeypatch,
                                            name, fault):
    roots, spec = room
    _faults(monkeypatch)[fault]()
    rc, line = run_cell(f"{name}.refactor", roots=roots, spec=spec)
    assert rc == 0 and line["correct"] is False, line


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fixture_reference_and_control(room, name):
    roots, _ = room
    conf = CONFIGS[name]
    limit = conf["limits"]["factor_backward_error"]
    assert dense_reading(conf, None, roots=roots) <= limit / 3
    assert dense_reading(conf, reference.rung(conf)["mantissa"],
                         roots=roots) > limit


def test_family_is_kernel_probes_matrix(room):
    from spfx_torch.bench.kernel_probe import magnetic_laplacian
    roots, _ = room
    f = specs.load_module("families", "maglap_fixture", roots).Family(
        {"grid": 6})
    A, B = f.matrix(f.middle()), magnetic_laplacian(6)
    assert B.has_sorted_indices
    for a, b in ((A.indptr, B.indptr), (A.indices, B.indices),
                 (A.data, B.data)):
        assert np.array_equal(a, b)


def test_exact_complex_factor_reads_rounding():
    """The exact complex128 Cholesky factor of the 6^3 magnetic Laplacian
    reads rounding (the check in float64 read it 4.6e-2); judged as L L^T
    instead of L L^H, it fails."""
    from spfx_torch.bench.kernel_probe import magnetic_laplacian
    A = magnetic_laplacian(6)
    r, c = np.tril_indices(A.shape[0])
    lv = np.linalg.cholesky(A.toarray())[r, c]
    perm = np.arange(A.shape[0])
    assert reference.factor_backward_error(A, perm, r, c, lv) <= 1e-14
    assert reference.factor_backward_error(A, perm, r, c, lv, lv) > CONFIGS[
        "maglap3d-48-chol-c64"]["limits"]["factor_backward_error"]


def test_complex_solution_residual():
    from spfx_torch.bench.kernel_probe import magnetic_laplacian
    A = magnetic_laplacian(4)
    g = np.random.default_rng(3)
    B = g.standard_normal((A.shape[0], 2)) + 1j * g.standard_normal(
        (A.shape[0], 2))
    X = np.linalg.solve(A.toarray(), B)
    assert reference.scaled_residual(A, X, B) <= 1e-15
    assert reference.scaled_residual(A, X.real, B) > 1e-2
    assert reference.scaled_residual(A, X.astype(np.complex64), B) > 1e-9


@pytest.mark.parametrize("dtype", sorted(reference.LADDER))
def test_ladder_check_is_what_the_check_computes_in(dtype):
    assert reference.working(np.zeros(1, dtype)) is np.dtype(
        reference.LADDER[dtype]["check"]).type


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_round_mantissa_float64_and_complex(dtype):
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -3.0,
                      1.0 + 2.0 ** -12], dtype=getattr(torch, dtype))
    y = reference.round_mantissa(x, 10)
    assert y.dtype == x.dtype
    assert y.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0, 1.0]
    z = torch.complex(x, -x.flip(0))
    assert torch.equal(reference.round_mantissa(z.conj(), 10), torch.complex(
        y, reference.round_mantissa(x.flip(0), 10)))


@pytest.mark.parametrize("dtype", ["float64", "complex64", "complex128"])
def test_dense_factors_in_their_dtype(dtype):
    from spfx_torch.bench.kernel_probe import magnetic_laplacian
    A = magnetic_laplacian(4, unsym=True)
    if not dtype.startswith("complex"):
        A = abs(A)          # the pattern with real values
    n = A.shape[0]
    r, c = np.tril_indices(n)
    L, U = reference.dense_lu(A.toarray(), dtype=dtype)
    assert L.dtype == U.dtype == getattr(torch, dtype)
    err = reference.factor_backward_error(
        A, np.arange(n), r, c, L.numpy()[r, c], U.numpy().T[r, c])
    assert err <= (1e-6 if dtype == "complex64" else 1e-14)


@pytest.fixture(scope="module")
def twin_plans():
    """{kind: (float32 plan, complex64 plan)} of one 6^3 pattern: the
    Laplacian and the magnetic Laplacian (its unsymmetric variant for
    LU)."""
    import spfx_torch
    from spfx_torch.bench.kernel_probe import magnetic_laplacian
    out = {}
    for name, ctx in (("cholesky", spfx_torch.Cholesky),
                      ("lu", spfx_torch.LU)):
        A = magnetic_laplacian(6, unsym=name == "lu")
        out[name] = tuple(
            ctx(M, spfx_torch.Config(dtype=dt), device="cpu").plan
            for M, dt in ((abs(A), "float32"), (A, "complex64")))
    return out


def index_bytes(plan, kernel, arrays):
    """The bytes of the int32 tables a kernel's calls read, which do not
    follow the element size: a start a window, an entry a block."""
    if kernel == "window_gather2":
        return 4.0 * arrays * sum(len(ub.src_start) + len(ub.head_start)
                                  for lp in plan.levels
                                  for ub in lp.updates)
    return 4.0 * sum(w.shape[0] for w, _ in bounds.plan_diag_calls(plan))


@pytest.mark.parametrize("kind,kernel,arrays", [
    ("cholesky", "window_gather2", 1), ("cholesky", "potrf_inv", 1),
    ("lu", "window_gather2", 2), ("lu", "getrf_inv", 2)])
def test_complex_bounds_double_the_bytes_and_quadruple_the_operations(
        twin_plans, kind, kernel, arrays):
    real, cplx = twin_plans[kind]
    b32, o32 = bounds.path_work(real, kernel, "float32", arrays)
    b64, o64 = bounds.path_work(cplx, kernel, "complex64", arrays)
    idx = index_bytes(real, kernel, arrays)
    assert idx == index_bytes(cplx, kernel, arrays) > 0
    assert b64 - idx == 2 * (b32 - idx) > 0
    assert o64 == 4 * o32 and (o32 > 0) == (kernel != "window_gather2")
    assert bounds.path_bound_ms(cplx, kernel, "complex64", arrays) == max(
        b64 / 3.35e12, o64 / 67e12) * 1e3


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fixture_control_on_the_card(room, name):
    """The fixture as configured passes its check and its control one rung
    below on the ladder (float64: the program at float32) fails it, at a
    grid a test run can hold."""
    card()
    from portbench.calibrate import readings
    roots, spec = room
    limits = CONFIGS[name]["limits"]
    dev = torch.device("cuda", 0)
    for side, ok in (("program", True), ("control", False)):
        for r in readings(f"{name}.refactor", [7, 8, 9], 4, side, dev,
                          patch={"grid": 20}, roots=roots, spec=spec):
            passed = all(v <= limits[k] for k, v in r["checks"].items())
            assert passed is ok, r
