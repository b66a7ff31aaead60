"""Coarsest-level solvers.

The reference's coarsest solve is one BoomerAMG V-cycle by default
(tg.hpp:724-730), UMFPACK direct in serial with --coarse-direct
(HypreDirect, tg.cpp:61-82), or AMG-preconditioned PCG to 1e-12
(AMGSolver, solve.cpp:240).  hypre does not exist on the device; the coarsest
operator is small by construction, so the replacements are:

  - DirectSolver: sparse LU (host factorization; also exported as dense
    Cholesky factors for the jitted device V-cycle)
  - CGSolver: plain CG to a tight tolerance (AMGSolver analog when a
    factorization is unwanted)
  - CorrectNullspace: the extra scaling-P coarse correction
    (solve.cpp:52-164), used when the spectral coarsest operator is too
    hard for a naive solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from saamge_jax.solve import smoothers
from saamge_jax.utils.logging import sa_print


class DirectSolver:
    """HypreDirect / UMFPACK replacement (tg.cpp:61-82)."""

    def __init__(self, Ac: sp.csr_matrix):
        self.n = Ac.shape[0]
        self._Ac = Ac.tocsc()
        self.lu = spla.splu(self._Ac)

    def mult(self, b: np.ndarray, x: np.ndarray) -> None:
        x[:] = self.lu.solve(b)

    # SuperLU objects don't pickle; refactorize on load so whole
    # hierarchies serialize (checkpoint/resume, SURVEY §5)
    def __getstate__(self):
        return {"n": self.n, "_Ac": self._Ac}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.lu = spla.splu(self._Ac)


class CGSolver:
    """AMGSolver analog (solve.cpp:240): iterate to rel_tol 1e-12.

    Preconditioned by weighted-l1 Jacobi rather than BoomerAMG; since it
    iterates to convergence the result is an (almost) exact coarse solve
    either way."""

    def __init__(self, Ac: sp.csr_matrix, rel_tol: float = 1e-12,
                 iters_coeff: float = 10.0):
        self.A = Ac
        self.rel_tol = rel_tol
        self.maxiter = int(iters_coeff * Ac.shape[0]) + 10
        self.dinv = smoothers.weighted_l1_dinv(Ac)
        self.cumulative_iterations = 0

    def mult(self, b: np.ndarray, x: np.ndarray) -> None:
        x[:] = 0.0
        r = b.copy()
        z = self.dinv * r
        d = z.copy()
        nom0 = nom = float(r @ z)
        if nom <= 0.0:
            return
        tol2 = self.rel_tol * nom0
        for it in range(self.maxiter):
            Ad = self.A @ d
            den = float(d @ Ad)
            if den <= 0.0:
                break
            alpha = nom / den
            x += alpha * d
            r -= alpha * Ad
            z = self.dinv * r
            betanom = float(r @ z)
            self.cumulative_iterations += 1
            if betanom <= tol2:
                break
            d = z + (betanom / nom) * d
            nom = betanom


class VCycleCoarseSolver:
    """Recursion glue: a coarser level's full V-cycle used as this level's
    coarse solver (ml_impose_cycle, ml.cpp:361)."""

    def __init__(self, tg_data, A: sp.csr_matrix):
        self.tg_data = tg_data
        self.A = A

    def mult(self, b: np.ndarray, x: np.ndarray) -> None:
        from saamge_jax.solve.vcycle import tg_cycle
        x[:] = 0.0
        tg_cycle(self.A, self.tg_data, b, x)


class CorrectNullspace:
    """solve.cpp:52-164: at the spectral coarsest level, smooth with SAS(nu)
    and correct through the scaling-P ("nullspace") level where the
    operator is hypre-friendly; solve there (exactly, standing in for one
    BoomerAMG V-cycle)."""

    def __init__(self, Ac: sp.csr_matrix, scaling_P: sp.csr_matrix,
                 smoother_steps: int = 3, smooth_phat: bool = False,
                 v_cycle: bool = True):
        from saamge_jax.setup.interp import interp_smooth
        self.A = Ac
        self.poly_data = smoothers.init_poly_data(Ac, smoother_steps, "sas")
        interp = scaling_P
        if smooth_phat:
            roots = smoothers.sa_poly_roots(3)
            interp = interp_smooth(Ac, interp, self.poly_data.dinv, roots, 1,
                                   0.0)
        self.interp = interp.tocsr()
        self.restr = self.interp.T.tocsr()
        self.Acc = (self.restr @ Ac @ self.interp).tocsr()
        sa_print(8, "[correctnulspace] Ac %dx%d -> Acc %dx%d",
                 Ac.shape[0], Ac.shape[1], self.Acc.shape[0],
                 self.Acc.shape[1])
        self.coarse = DirectSolver(self.Acc)

    def mult(self, b: np.ndarray, x: np.ndarray) -> None:
        x[:] = 0.0
        x[:] = smoothers.sym_poly(self.A, b, x, self.poly_data)
        res = b - self.A @ x
        resc = self.restr @ res
        xc = np.zeros(self.Acc.shape[0])
        self.coarse.mult(resc, xc)
        x += self.interp @ xc
        x[:] = smoothers.sym_poly(self.A, b, x, self.poly_data)


def make_coarse_solver(Ac: sp.csr_matrix, kind: str = "direct",
                       scaling_P: Optional[sp.csr_matrix] = None):
    if kind == "direct":
        return DirectSolver(Ac)
    if kind == "cg":
        return CGSolver(Ac)
    if kind == "correct_nullspace":
        assert scaling_P is not None
        return CorrectNullspace(Ac, scaling_P)
    raise ValueError(kind)
