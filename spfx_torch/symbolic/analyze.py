"""Symbolic analysis orchestrator (ref SparseFrame_analyze,
Cholesky/Source/SparseFrame.c:1916-1978; LU variant :2233-2458).

Pipeline: fill-reducing ordering -> elimination tree -> column counts ->
weighted postorder -> (re-permute) -> fundamental supernodes -> relaxed
amalgamation -> supernodal row patterns -> level schedule.

For the LU line the caller passes ``symmetrize=True`` so analysis runs on the
pattern of A + A^T (ref CPCT builder, LU/Source/SparseFrame.c:2254-2396); the
resulting symmetric-pattern supernode structure hosts both the L panel and the
U^T panel (same row pattern) exactly as the reference stores L and U blocks
side by side (LU/Source/SparseFrame.c:1786-1797).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from spfx_torch.ordering import order
from spfx_torch.utils.config import Config, DEFAULT
from .etree import etree, postorder, col_counts, etree_levels
from .supernodes import (fundamental_supernodes, amalgamate, sn_of_map,
                         sn_patterns)


@dataclasses.dataclass
class Symbolic:
    """Static symbolic factorization: everything the numeric phase needs.

    The analogue of the reference's matrix_info symbolic fields
    (Nsuper/Super/Lsip/Lsi/ST_*/Leaf*, Cholesky/Include/info.h:70-150), but
    expressed as a level schedule instead of a dynamic leaf queue.
    """
    n: int
    perm: np.ndarray          # final permutation (fill ordering ∘ postorder)
    parent: np.ndarray        # etree of the permuted pattern
    counts: np.ndarray        # factor column counts (incl diagonal)
    sn_start: np.ndarray      # (nsuper+1,) supernode column ranges
    sn_of: np.ndarray         # (n,) column -> supernode
    sn_ptr: np.ndarray        # (nsuper+1,) into sn_rows
    sn_rows: np.ndarray       # concatenated sorted global row patterns
    sn_level: np.ndarray      # (nsuper,) static schedule level per supernode
    nnzL: int
    flops: float              # ~ sum of colcount^2 (Cholesky convention)

    @property
    def nsuper(self) -> int:
        return len(self.sn_start) - 1

    def sn_cols(self, s: int) -> np.ndarray:
        return np.arange(self.sn_start[s], self.sn_start[s + 1])

    def sn_row_list(self, s: int) -> np.ndarray:
        return self.sn_rows[self.sn_ptr[s]:self.sn_ptr[s + 1]]

    @property
    def xsize(self) -> int:
        """Total dense panel storage (sum of nsrow*nscol over supernodes)."""
        w = (self.sn_start[1:] - self.sn_start[:-1])
        r = (self.sn_ptr[1:] - self.sn_ptr[:-1])
        return int((w * r).sum())


def analyze(A: sp.spmatrix, config: Config = DEFAULT,
            symmetrize: bool = False) -> Symbolic:
    """Run the full symbolic pipeline on the symmetric pattern of A."""
    A = sp.csc_matrix(A)
    n = A.shape[0]
    pat = (A != 0).astype(np.int8)
    if symmetrize:
        pat = ((pat + pat.T) != 0).astype(np.int8)
    pat = sp.csc_matrix(pat)
    pat.setdiag(1)

    # 1. fill-reducing ordering (ref :1937, METIS active)
    perm0 = order(pat, config.ordering)
    Ap = pat[perm0][:, perm0].tocsc()

    # 2. etree + counts on the fill-ordered pattern
    par0 = etree(Ap)
    cnt0 = col_counts(Ap, par0)

    # 3. postorder weighted by column counts (ref runs postorder twice,
    #    :1961/:1967 — unweighted then ColCount-weighted) and re-permute
    post = postorder(par0, weight=cnt0)
    perm = perm0[post]
    App = Ap[post][:, post].tocsc()

    # 4. recompute tree/counts in postordered labels (the reference re-runs
    #    perm after composing perm∘post, :1429-1447)
    parent = etree(App)
    counts = col_counts(App, parent)

    # 5. supernodes: fundamental split + relaxed amalgamation
    fstart = fundamental_supernodes(parent, counts, config.max_sn_cols)
    sn_start = amalgamate(fstart, parent, counts, config)
    sn_of = sn_of_map(sn_start, n)

    # 6. supernodal row patterns
    sn_ptr, sn_rows = sn_patterns(App, parent, sn_start, sn_of)

    # 7. static level schedule: node levels -> supernode level via last col,
    #    compressed to dense ranks (empty levels would waste schedule steps)
    nlev = etree_levels(parent)
    raw = nlev[sn_start[1:] - 1]
    sn_level = np.searchsorted(np.unique(raw), raw).astype(np.int64)

    c = counts.astype(np.float64)
    return Symbolic(
        n=n, perm=perm, parent=parent, counts=counts,
        sn_start=sn_start, sn_of=sn_of, sn_ptr=sn_ptr, sn_rows=sn_rows,
        sn_level=sn_level, nnzL=int(counts.sum()), flops=float((c * c).sum()),
    )
