"""The inputs: the matrix families, and the value sets and right-hand
sides drawn from the seed."""

import numpy as np
import pytest
import scipy.sparse as sp

from portbench import spec as specs
from portbench.families.gen57pt import Family

POISSON = dict(grid=5, operator="shifted_poisson", shift_lo=0.01,
               shift_hi=1.0)
CONVDIFF = dict(grid=5, operator="convection_diffusion", beta_lo=0.0,
                beta_hi=1.0, diag_shift=0.01)


def laplacian(k):
    T = sp.diags([-np.ones(k - 1), 2 * np.ones(k), -np.ones(k - 1)],
                 [-1, 0, 1])
    I = sp.identity(k)
    return (sp.kron(I, sp.kron(I, T)) + sp.kron(I, sp.kron(T, I))
            + sp.kron(T, sp.kron(I, I)))


def test_poisson_is_the_shifted_laplacian():
    f = Family(POISSON)
    data = f.values(np.random.default_rng(3), 4)
    shifts = []
    for d in data:
        A = f.matrix(d)
        s = A.diagonal()[0] - 6.0
        assert abs(A - laplacian(5) - s * sp.identity(125)).max() < 1e-15
        shifts.append(s)
    # the midpoints of four equal strata of [0.01, 1], in some order
    assert sorted(shifts) == pytest.approx(
        [0.01 + 0.99 * (k + 0.5) / 4 for k in range(4)])
    middle = f.matrix(f.middle())
    assert abs(middle - laplacian(5)
               - 0.505 * sp.identity(125)).max() < 1e-15


def test_convection_diffusion_is_upwinded_and_dominant():
    f = Family(CONVDIFF)
    mids = [(k + 0.5) / 4 for k in range(4)]
    for d in f.values(np.random.default_rng(4), 4):
        A = f.matrix(d).toarray()
        i = 1 + 5 * 1 + 25 * 1                # interior point (1, 1, 1)
        beta = [-1 - A[i, i - stride] for stride in (1, 5, 25)]
        assert all(min(abs(b - m) for m in mids) < 1e-12 for b in beta)
        for stride in (1, 5, 25):
            assert A[i, i + stride] == -1.0
        assert A[i, i] == pytest.approx(6 + sum(beta) + 0.01)
    off = np.abs(A).sum(1) - np.abs(np.diag(A))
    assert (np.diag(A) - off >= 0.01 - 1e-12).all()
    assert (A != A.T).any() and ((A != 0) == (A.T != 0)).all()


@pytest.mark.parametrize("params", [POISSON, CONVDIFF])
def test_values_are_deterministic_per_seed(params):
    f = Family(params)
    a = f.values(np.random.default_rng(2**40 + 7), 16)
    b = f.values(np.random.default_rng(2**40 + 7), 16)
    c = f.values(np.random.default_rng(2**40 + 8), 16)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # another seed, the same values of each parameter in another order: the
    # diagonal's shift, or the upstream x coefficient's beta_x
    kind = 0 if params is POISSON else 1
    got = [sorted(x[f.kinds == kind][0] for x in v) for v in (a, c)]
    assert got[0] == got[1]
    assert all(np.array_equal(f.matrix(x).indices, f.indices) for x in a)


@pytest.mark.parametrize("mix", ["refactor", "solve16"])
def test_cell_inputs_are_deterministic_per_seed(mix):
    from portbench.drivers.sparse_direct import Cell
    conf = dict(POISSON, kind="cholesky", family="gen57pt",
                program_config={})
    m = specs.load_json("traffic", mix)
    big = 3_000_000_000_000
    cells = [Cell(conf, m, s, "cpu") for s in (big, big, -big)]
    for c in cells:
        c._draw(c.seed)
    for x, y in zip(cells[0].values + cells[0].rhs,
                    cells[1].values + cells[1].rhs):
        assert np.array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(
        cells[0].values + cells[0].rhs, cells[2].values + cells[2].rhs))
    assert len(cells[0].values) == m["pool"]
    assert len(cells[0].rhs) == (m["pool"] if m["op"] == "solve" else 0)
