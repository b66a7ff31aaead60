"""Two-grid data and hierarchy construction (tg.{hpp,cpp} analog)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from saamge_jax.setup import interp as interp_mod
from saamge_jax.setup.contrib import (linear_vectors, ones_vectors,
                                      rbm_vectors)
from saamge_jax.setup.interp import InterpData, interp_init_data
from saamge_jax.solve import smoothers
from saamge_jax.solve.coarse import make_coarse_solver
from saamge_jax.topology.agglomerate import AggPartRels
from saamge_jax.utils.logging import TIMERS, sa_assert, sa_print


@dataclasses.dataclass
class TGData:
    """tg_data_t analog (tg_data.hpp:47-83)."""

    interp_data: InterpData
    poly_data: smoothers.PolyData
    theta: float
    smooth_interp: bool
    ltent_interp: Optional[sp.csr_matrix] = None
    tent_interp: Optional[sp.csr_matrix] = None
    interp: Optional[sp.csr_matrix] = None
    restr: Optional[sp.csr_matrix] = None
    scaling_P: Optional[sp.csr_matrix] = None
    Ac: Optional[sp.csr_matrix] = None
    polynomial_coarse_space: int = -1
    doing_spectral: bool = False
    tag: int = -1
    coarse_solver: object = None
    elem_data: object = None


def tg_init_data(A: sp.csr_matrix, rels: AggPartRels, nu_pro: int,
                 nu_relax: int, theta: float, smooth_interp: bool,
                 smooth_drop_tol: float = 0.0,
                 use_truncated_eigensolver: bool = False,
                 use_batched_eigensolver: bool = False,
                 setup_mesh=None, smoother_family: str = "sas",
                 smoother_param: float = 0.0) -> TGData:
    """tg_init_data (tg.cpp:402).  ``smoother_family``/``smoother_param``
    select the relaxation root family (the reference hardcodes SAS at
    smpr.cpp:376; invx takes the spectral parameter ``a``)."""
    interp_data = interp_init_data(rels, nu_pro, use_truncated_eigensolver)
    interp_data.drop_tol = smooth_drop_tol
    interp_data.use_batched_eigensolver = use_batched_eigensolver
    interp_data.setup_mesh = setup_mesh
    with TIMERS.phase("setup.dinv"):
        poly_data = smoothers.init_poly_data(A, nu_relax, smoother_family,
                                             smoother_param)
    return TGData(interp_data=interp_data, poly_data=poly_data, theta=theta,
                  smooth_interp=smooth_interp)


def tg_smooth_interp(A: sp.csr_matrix, tg: TGData) -> None:
    """tg_smooth_interp (tg.hpp:678)."""
    if tg.smooth_interp:
        with TIMERS.phase("setup.interp_smooth"):
            tg.interp = interp_mod.interp_smooth(
                A, tg.tent_interp, tg.poly_data.dinv,
                tg.interp_data.interp_smoother_roots,
                tg.interp_data.times_apply_smoother,
                tg.interp_data.drop_tol)
    else:
        tg.interp = tg.tent_interp.copy()
    tg.restr = tg.interp.T.tocsr()


def tg_assemble_and_smooth(A: sp.csr_matrix, tg: TGData,
                           rels: AggPartRels) -> None:
    """tg_assemble_and_smooth (tg.cpp:432).

    Single-host: the global tentative P equals the local one (the
    (Dof_TrueDof)^T fold, interp.cpp:761, is the identity)."""
    tg.tent_interp = tg.ltent_interp.tocsr()
    if tg.interp_data.scaling_P:
        one_rep = tg.interp_data.tent.local_coarse_one_representation
        tg.scaling_P = _scaling_P_assemble(rels, tg.interp_data, one_rep)
    tg_smooth_interp(A, tg)
    sa_print(3, "COARSE SPACE DIMENSION: %d", tg.interp.shape[1])


def _scaling_P_assemble(rels: AggPartRels, interp_data: InterpData,
                        one_rep: np.ndarray) -> sp.csr_matrix:
    """interp_scaling_P_assemble (interp.cpp:842): coarse dofs x (MISes with
    coarse dofs), entries = normalized LLS fit of ones per MIS."""
    ncd = interp_data.mis_numcoarsedof
    rows, cols, vals = [], [], []
    col = 0
    run = 0
    for mis in range(rels.num_mises):
        k = int(ncd[mis])
        if k > 0:
            rows.extend(range(run, run + k))
            cols.extend([col] * k)
            vals.extend(one_rep[run:run + k])
            col += 1
        run += k
    return sp.coo_matrix((vals, (rows, cols)), shape=(run, col)).tocsr()


def tg_build_hierarchy(A: sp.csr_matrix, tg: TGData, rels: AggPartRels,
                       elem_data, avoid_ess_bdr_dofs: bool = True,
                       coords: Optional[np.ndarray] = None,
                       sdim: int = 0, num_nodes: int = 0) -> None:
    """tg_build_hierarchy (tg.cpp:502) + _with_polynomial (tg.cpp:478).

    polynomial_coarse_space: -1 spectral, 0 constants, 1 linears/RBMs
    (composite with spectral when theta > 0)."""
    tg.elem_data = elem_data
    pcs = tg.polynomial_coarse_space
    if pcs == -1 and tg.theta > 0.0:
        tg.doing_spectral = True
        tg.ltent_interp = interp_mod.sparse_tent_build(
            rels, tg.interp_data, elem_data, tg.theta,
            avoid_ess_bdr_dofs=avoid_ess_bdr_dofs)
        # the reference updates theta in place with the suggestion
        # (interp.cpp:588, tg.cpp:520 passes tg_data->theta by ref);
        # subsequent re-builds (adaptivity) then use it
        if tg.interp_data.suggested_theta is not None:
            tg.theta = tg.interp_data.suggested_theta
    else:
        use_spectral = tg.theta > 0.0 and pcs != 0
        tg.doing_spectral = use_spectral
        if use_spectral:
            interp_mod.compute_vectors(rels, tg.interp_data, elem_data,
                                       tg.theta)
        if pcs == 0:
            extra = ones_vectors(rels)
        elif pcs == 1:
            assert coords is not None
            if num_nodes == rels.ND:
                extra = linear_vectors(rels, coords)
            else:
                extra = rbm_vectors(rels, coords, sdim)
        else:
            extra = ones_vectors(rels)
        tg.ltent_interp = interp_mod.sparse_tent_assemble(
            rels, tg.interp_data, avoid_ess_bdr_dofs, extra_vectors=extra,
            use_spectral=use_spectral)
    tg_assemble_and_smooth(A, tg, rels)


def tg_coarse_matr(A: sp.csr_matrix, interp: sp.csr_matrix) -> sp.csr_matrix:
    """Galerkin triple product (tg.hpp:696, hypre RAP)."""
    with TIMERS.phase("setup.rap"):
        Ac = (interp.T @ A @ interp).tocsr()
    Ac.sort_indices()
    sa_print(3, "Ac nnz: %d, A nnz: %d, OC: %g", Ac.nnz, A.nnz,
             Ac.nnz / max(A.nnz, 1) + 1.0)
    # expensive invariants (debug ladder; reference asserts Ac SPD-ness
    # implicitly through hypre RAP + the smoother contracts)
    sa_assert(7, lambda: abs(Ac - Ac.T).max()
              <= 1e-10 * max(1.0, abs(Ac).max()),
              "RAP product not symmetric")
    sa_assert(7, lambda: bool(np.all(Ac.diagonal() > 0)),
              "RAP product has non-positive diagonal")
    return Ac


def tg_update_coarse_operator(A: sp.csr_matrix, tg: TGData,
                              perform_solve_init: bool,
                              coarse_solver_kind: str = "direct",
                              rap_fn=None) -> None:
    """tg_update_coarse_operator (tg.cpp:979).

    ``rap_fn``: optional replacement for the host Galerkin product
    (e.g. the device structured RAP, setup/device_rap.py); returning
    None falls back to the host scipy product."""
    Ac = rap_fn(A, tg) if rap_fn is not None else None
    tg.Ac = Ac if Ac is not None else tg_coarse_matr(A, tg.interp)
    tg.coarse_solver = None
    if perform_solve_init:
        tg.coarse_solver = make_coarse_solver(tg.Ac, coarse_solver_kind)


def tg_fillin_coarse_operator(A: sp.csr_matrix, tg: TGData,
                              perform_solve_init: bool = True) -> None:
    if tg.Ac is None:
        tg_update_coarse_operator(A, tg, perform_solve_init)


def tg_produce_data(A: sp.csr_matrix, rels: AggPartRels, nu_pro: int,
                    nu_relax: int, elem_data, theta: float,
                    smooth_interp: bool, polynomial_coarse: int = -1,
                    use_truncated_eigensolver: bool = False,
                    avoid_ess_bdr_dofs: bool = True) -> TGData:
    """tg_produce_data (tg.cpp:917) — two-level only."""
    tg = tg_init_data(A, rels, nu_pro, nu_relax, theta, smooth_interp,
                      0.0, use_truncated_eigensolver)
    tg.polynomial_coarse_space = polynomial_coarse
    tg_build_hierarchy(A, tg, rels, elem_data, avoid_ess_bdr_dofs)
    return tg


def tg_augment_interp_with_identity(tg: TGData, k: int) -> None:
    """tg_augment_interp_with_identity (tg.cpp:542): re-add k eliminated
    leading DoFs as identity rows/columns (algebraic pure-Neumann fix)."""
    P = tg.interp.tocoo()
    n, m = P.shape
    rows = np.concatenate([np.arange(k), P.row + k])
    cols = np.concatenate([np.arange(k), P.col + k])
    vals = np.concatenate([np.ones(k), P.data])
    tg.interp = sp.coo_matrix((vals, (rows, cols)),
                              shape=(n + k, m + k)).tocsr()
    tg.restr = tg.interp.T.tocsr()
    tg.Ac = None
    tg.coarse_solver = None
