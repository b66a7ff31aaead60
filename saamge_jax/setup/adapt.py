"""Adaptivity: convergence-factor probing and hierarchy reuse.

Reference: adapt.{hpp,cpp}.  adapt_approx_xbad (adapt.cpp:49) runs V-cycles
on A x = 0 from a random start to measure the (asymptotic) convergence factor
and expose the slow-to-converge error ("bad guy").  adapt_update_operators
(adapt.cpp:171-216) refreshes the smoother diagonals, optionally re-smooths
the (old) tentative prolongators, and recomputes the Galerkin products after
the fine operator changed — reusing the coarse basis.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from saamge_jax.setup import tg as tg_mod
from saamge_jax.setup.ml import MLData, MultilevelParameters, ml_impose_cycle
from saamge_jax.solve import smoothers
from saamge_jax.solve.coarse import CorrectNullspace
from saamge_jax.solve.vcycle import tg_cycle
from saamge_jax.utils.logging import sa_print

ADAPT_XBAD_ERR_TOL_FLAG = 1
ADAPT_XBAD_MAX_ITER_FLAG = 2
ADAPT_XBAD_ERR_INC_FLAG = 4


def adapt_approx_xbad(A: sp.csr_matrix, tg_data, maxiter: int,
                      xbad: np.ndarray, rtol: float = 1e-12,
                      atol: float = 0.0, normalize: bool = False,
                      rng=None) -> Tuple[int, dict]:
    """adapt_approx_xbad (adapt.cpp:49).  Returns (reason flags, stats);
    mutates xbad in place."""
    b = np.zeros(A.shape[0])
    err = float(np.sqrt(xbad @ (A @ xbad)))
    xbad /= err
    err = err0 = 1.0
    ende = max(rtol * err, atol)
    cf = np.inf
    acf = 0.0
    reason = 0
    i = 1
    iters = 0
    while True:
        if err <= ende:
            reason |= ADAPT_XBAD_ERR_TOL_FLAG
        if i > maxiter:
            reason |= ADAPT_XBAD_MAX_ITER_FLAG
        if reason:
            return reason, dict(cf=cf, acf=acf, err=err, iters=iters)
        err_prev = err
        tg_cycle(A, tg_data, b, xbad)
        err = float(np.sqrt(xbad @ (A @ xbad)))
        cf = err / err_prev
        acf = (err / err0) ** (1.0 / i)
        iters = i
        if normalize:
            xbad /= err
            err = 1.0
        if err > err_prev:
            reason |= ADAPT_XBAD_ERR_INC_FLAG
            return reason, dict(cf=cf, acf=acf, err=err, iters=iters)
        i += 1


def tg_adapt(A: sp.csr_matrix, tg_data, rels, elem_data,
             probe_iters: int = 10, readapting: bool = False,
             tol: float = 1e-3, rng=None,
             avoid_ess_bdr_dofs: bool = True) -> dict:
    """One adaptive enrichment step (the xbad path of
    interp_compute_vectors, interp.cpp:430-497 + spectral.cpp:151-166):

      1. probe the current two-grid cycle on A x = 0 from a random start to
         expose the slowest-converging error ("bad guy"),
      2. orthogonalize it into each AE's basis and re-solve the local
         eigenproblems in the enriched subspace (or just append it when
         ``readapting``),
      3. rebuild the tentative prolongator, re-smooth, re-RAP.

    Returns stats including the probed convergence factor and whether any
    AE enriched its basis."""
    from saamge_jax.setup import interp as interp_mod
    from saamge_jax.solve.coarse import make_coarse_solver

    rng = rng or np.random.default_rng(0)
    xbad = rng.standard_normal(A.shape[0])
    # respect essential BCs (helpers_random_vect semantics)
    ess = (rels.agg_flags & 1) != 0
    xbad[ess] = 0.0
    reason, stats = adapt_approx_xbad(A, tg_data, probe_iters, xbad,
                                      normalize=True)
    tg_data.ltent_interp = interp_mod.sparse_tent_build(
        rels, tg_data.interp_data, elem_data, tg_data.theta,
        avoid_ess_bdr_dofs=avoid_ess_bdr_dofs,
        xbad=xbad, transf=True, readapting=readapting, tol=tol)
    tg_mod.tg_assemble_and_smooth(A, tg_data, rels)
    tg_data.Ac = tg_mod.tg_coarse_matr(A, tg_data.interp)
    tg_data.coarse_solver = make_coarse_solver(tg_data.Ac, "direct")
    stats["reason"] = reason
    return stats


def adapt_update_operators_tg(A: sp.csr_matrix, tg_data,
                              resmooth_interp: bool = True) -> None:
    """adapt_update_operators for one level (adapt.cpp:171)."""
    smoothers.update_dinv(A, tg_data.poly_data)
    if (resmooth_interp and tg_data.smooth_interp
            and len(tg_data.interp_data.interp_smoother_roots) > 0):
        tg_mod.tg_smooth_interp(A, tg_data)
    tg_data.Ac = None
    tg_data.coarse_solver = None


def adapt_update_operators_ml(A: sp.csr_matrix, ml: MLData,
                              mlp: MultilevelParameters,
                              resmooth_interp: bool = True) -> None:
    """adapt_update_operators for the hierarchy (adapt.cpp:189): fresh
    Dinv + RAP per level, same coarse bases."""
    Af = A
    for idx, level in enumerate(ml.levels):
        level.A = Af
        adapt_update_operators_tg(Af, level.tg_data, resmooth_interp)
        is_coarsest = idx + 1 == len(ml.levels)
        tg_mod.tg_update_coarse_operator(
            Af, level.tg_data, perform_solve_init=is_coarsest,
            coarse_solver_kind=mlp.coarse_solver_kind)
        Af = level.tg_data.Ac
    ml_impose_cycle(ml)
    if mlp.use_correct_nullspace:
        tg = ml.coarsest.tg_data
        tg.coarse_solver = CorrectNullspace(tg.Ac, tg.scaling_P, 3,
                                            smooth_phat=False, v_cycle=True)
    sa_print(4, "adapt: operators updated, hierarchy reused")
