"""SPARSKIT MATGEN's ``gen57pt`` family (Y. Saad): the 7-point finite
difference operator on an nx x ny x nz grid with Dirichlet boundaries,
made on the host with scipy, vectorised.

Parameters (keys of the configuration's file):

- ``grid``: points along each axis (n = grid^3);
- ``operator``: ``"shifted_poisson"``, the Laplacian (diagonal 6,
  neighbours -1) plus s I, s in [shift_lo, shift_hi] (an implicit
  heat-equation step); or ``"convection_diffusion"``, upwinded: in each
  axis d the upstream neighbour -(1 + beta_d), the downstream one -1, the
  diagonal 6 + sum(beta) + ``diag_shift``, each beta_d in [beta_lo,
  beta_hi] (a Picard or Newton step's velocities).

A pool of ``count`` value sets takes each parameter at the midpoints of
``count`` equal strata of its range, in an order drawn from the seed (one
order a parameter): every seed gets the same values, so the seed changes
no work (the conditioning, and with it the refinement's sweeps, follows
the values). Every value set has the same pattern, so one context factors
them all.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# entry kinds in the stencil: the diagonal, then (axis, side) pairs
DIAG, UP_X, DOWN_X, UP_Y, DOWN_Y, UP_Z, DOWN_Z = range(7)


def pattern(grid: int):
    """(indptr, indices, kinds) of the CSC 7-point matrix on grid^3:
    ``kinds`` gives each stored entry's place in the stencil. Entry (i, j)
    with j = i - stride on axis d is i's upstream neighbour on d."""
    k = grid
    n = k ** 3
    idx = np.arange(n).reshape(k, k, k)          # (z, y, x)
    rows, cols, kinds = [np.arange(n)], [np.arange(n)], [np.full(n, DIAG)]
    for axis, (up, down) in enumerate(((UP_X, DOWN_X), (UP_Y, DOWN_Y),
                                       (UP_Z, DOWN_Z))):
        ax = 2 - axis                            # x is the last array axis
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, k - 1)
        hi[ax] = slice(1, k)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        # row b, column a: a is b's upstream neighbour; row a, column b:
        # b is a's downstream one
        rows += [b, a]
        cols += [a, b]
        kinds += [np.full(a.size, up), np.full(a.size, down)]
    r, c, t = (np.concatenate(x) for x in (rows, cols, kinds))
    K = sp.csc_matrix((t.astype(np.float64) + 1.0, (r, c)), shape=(n, n))
    K.sort_indices()
    return K.indptr, K.indices, (K.data - 1.0).astype(np.int64)


def strata(lo: float, hi: float, order) -> np.ndarray:
    """The midpoints of len(order) equal strata of [lo, hi], in ``order``
    (a permutation)."""
    return lo + (hi - lo) * (np.asarray(order) + 0.5) / len(order)


def value_sets(params: dict, rng, count: int):
    """``count`` value sets as coefficients of the 7 stencil kinds, one row
    each: (count, 7) float64. ``rng`` orders the strata; None takes the
    one stratum, the middle of each range, whatever ``count``."""
    def draw(lo, hi, k=None):
        if rng is None:
            return np.full((count,) if k is None else (count, k),
                           (lo + hi) / 2)
        cols = [strata(lo, hi, rng.permutation(count))
                for _ in range(k or 1)]
        return cols[0] if k is None else np.stack(cols, 1)

    coef = np.zeros((count, 7))
    if params["operator"] == "shifted_poisson":
        coef[:, DIAG] = 6.0 + draw(params["shift_lo"], params["shift_hi"])
        coef[:, 1:] = -1.0
    elif params["operator"] == "convection_diffusion":
        beta = draw(params["beta_lo"], params["beta_hi"], 3)
        coef[:, DIAG] = 6.0 + beta.sum(1) + params["diag_shift"]
        coef[:, [UP_X, UP_Y, UP_Z]] = -(1.0 + beta)
        coef[:, [DOWN_X, DOWN_Y, DOWN_Z]] = -1.0
    else:
        raise ValueError(f"gen57pt: unknown operator {params['operator']!r}")
    return coef


class Family:
    """The matrices of one configuration: one pattern, and the values of
    each set drawn from the seed."""

    def __init__(self, params: dict):
        self.params = params
        self.n = params["grid"] ** 3
        self.indptr, self.indices, self.kinds = pattern(params["grid"])

    def values(self, rng: np.random.Generator, count: int):
        """``count`` data arrays (CSC order), ordered by ``rng``."""
        return [c[self.kinds] for c in value_sets(self.params, rng, count)]

    def middle(self):
        """The data array of the value set at the middle of every range."""
        return self.values(None, 1)[0]

    def matrix(self, data) -> sp.csc_matrix:
        """A fresh matrix object over ``data`` (the pattern is shared)."""
        return sp.csc_matrix((data, self.indices, self.indptr),
                             shape=(self.n, self.n), copy=False)
