"""User-facing one-object solvers/preconditioners.

Equivalents of the reference's encapsulated interfaces:
  - SpectralAMGSolver (solve.hpp:149-181): geometric, from a mesh + problem.
  - SAAMGePC (saamgepc.cpp:130): geometric preconditioner.
  - SAAMGeAlgPC (saamgealgpc.cpp): algebraic (matrix-only) preconditioner.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import Mesh
from saamge_jax.setup import algebraic as alg
from saamge_jax.setup.elmat import GeometricProvider
from saamge_jax.setup.ml import MLData, MultilevelParameters, ml_produce_data
from saamge_jax.solve.pcg import PCGResult, pcg
from saamge_jax.solve.vcycle import VCycleSolver
from saamge_jax.topology.agglomerate import (FLAG_ESS_BDR, AggPartRels,
                                             create_partitioning_fine)
from saamge_jax.utils.logging import TIMERS, sa_print


def checkerboard_coef(x: np.ndarray) -> float:
    """The drivers' high-contrast checkerboard (mltest.cpp:151-175)."""
    d = 10.0
    cx = int(np.ceil(x[0] * d)) & 1
    cy = int(np.ceil(x[1] * d)) & 1
    if len(x) == 2:
        return 1e6 if cx == cy else 1.0
    cz = int(np.ceil(x[2] * d)) & 1
    if (cz and cx == cy) or ((not cz) and cx != cy):
        return 1e6
    return 1.0


def bdr_dof_flags(mesh: Mesh, ess_attr_marker: np.ndarray, order: int = 1,
                  vdim: int = 1) -> np.ndarray:
    """fem_find_bdr_dofs (fem.cpp:87): essential-boundary flags per dof."""
    nd = mesh.num_dofs(order) * vdim
    flags = np.zeros(nd, dtype=np.uint8)
    ess = assemble.ess_dofs_from_attrs(mesh, ess_attr_marker, order, vdim)
    flags[ess] |= FLAG_ESS_BDR
    return flags


def geometric_partitioning(A: sp.csr_matrix, mesh: Mesh,
                           bdr_flags: np.ndarray, nparts: int,
                           order: int = 1, vdim: int = 1,
                           do_aggregates: bool = False,
                           partitioning: Optional[np.ndarray] = None
                           ) -> AggPartRels:
    """fem_create_partitioning (fem.cpp:687)."""
    e2d = mesh.elem_to_dof(order, vdim)
    e2e = mesh.elem_to_elem()
    return create_partitioning_fine(A, e2d, e2e, partitioning, bdr_flags,
                                    nparts, do_aggregates)


@dataclasses.dataclass
class GeometricSolveResult:
    result: PCGResult
    ml: MLData
    A: sp.csr_matrix
    b: np.ndarray


class SpectralAMGSolver:
    """One-shot geometric solver: partition -> ml_produce_data -> V-cycle
    preconditioner (solve.cpp:167-230)."""

    def __init__(self, A: sp.csr_matrix, mesh: Mesh, elem_mats: np.ndarray,
                 opts: SolverOptions, order: int = 1, vdim: int = 1,
                 ess_attr_marker: Optional[np.ndarray] = None,
                 partitioning: Optional[np.ndarray] = None,
                 coarse_part_override=None, setup_mesh=None,
                 rap_override=None):
        opts = opts.resolved()
        self.opts = opts
        self.A = A
        if ess_attr_marker is None:
            ess_attr_marker = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        flags = bdr_dof_flags(mesh, ess_attr_marker, order, vdim)
        num_coarsenings = opts.num_levels - 1
        nparts0 = max(mesh.num_elements // opts.first_elems_per_agg, 1) \
            if partitioning is None else int(np.max(partitioning)) + 1
        with TIMERS.phase("setup.partitioning"):
            rels = geometric_partitioning(
                A, mesh, flags, nparts0, order, vdim,
                do_aggregates=opts.do_aggregates and num_coarsenings == 1,
                partitioning=partitioning)
        nparts_arr = [rels.nparts]
        for i in range(1, num_coarsenings):
            nparts_arr.append(max(int(round(nparts_arr[-1]
                                            / opts.elems_per_agg)), 1))
        self.mlp = MultilevelParameters(
            num_coarsenings=num_coarsenings, nparts_arr=nparts_arr,
            first_nu_pro=opts.first_nu_pro, nu_pro=opts.nu_pro,
            nu_relax=opts.nu_relax, first_theta=opts.first_theta,
            theta=opts.theta,
            polynomial_coarse_space=0 if opts.minimal_coarse else -1,
            use_correct_nullspace=opts.correct_nulspace,
            use_truncated_eigensolver=not opts.direct_eigensolver,
            use_batched_eigensolver=opts.device_setup,
            do_aggregates=opts.do_aggregates,
            use_double_cycle=opts.double_cycle,
            coarse_direct=opts.coarse_direct,
            smoother_poly_family=opts.smoother_poly_family,
            smoother_poly_param=opts.smoother_poly_param,
            setup_mesh=setup_mesh)
        if opts.linear_coarse or vdim > 1:
            self.mlp.set_polynomial_coarse_space(0, 1)
        emp = GeometricProvider(rels, A, elem_mats)
        coords = mesh.dof_coords(order)
        with TIMERS.phase("setup.ml_produce_data"):
            self.ml = ml_produce_data(
                A, rels, emp, self.mlp, coords=coords, sdim=mesh.dim,
                num_nodes=(mesh.num_dofs(order) if vdim == 1
                           else mesh.num_dofs(order) * vdim // vdim),
                coarse_part_override=coarse_part_override,
                rap_override=rap_override)
        if opts.double_cycle:
            from saamge_jax.solve.double_cycle import DoubleCycle
            self.precond = DoubleCycle(A, self.ml)
        else:
            self.precond = VCycleSolver(self.ml.finest.tg_data)
            self.precond.set_operator(A)

    def update_operator(self, A: sp.csr_matrix,
                        resmooth_interp: bool = True) -> None:
        """Hierarchy reuse after the operator changed (adaptation §3.5):
        fresh smoother diagonals + Galerkin products, same coarse bases
        (adapt_update_operators, adapt.cpp:189)."""
        from saamge_jax.setup.adapt import adapt_update_operators_ml
        self.A = A.tocsr()
        adapt_update_operators_ml(self.A, self.ml, self.mlp, resmooth_interp)
        self.precond.set_operator(self.A)

    def mult(self, r: np.ndarray) -> np.ndarray:
        z = np.zeros_like(r)
        self.precond.mult(r, z)
        return z

    def solve(self, b: np.ndarray, x0: Optional[np.ndarray] = None,
              verbose: bool = False) -> PCGResult:
        with TIMERS.phase("solve.pcg"):
            res = pcg(self.A, b, self.mult, x0=x0,
                      rel_tol=self.opts.rtol, max_iter=self.opts.maxiter,
                      verbose=verbose)
        if res.converged:
            sa_print(1, "Outer PCG converged in %d iterations.",
                     res.iterations)
        else:
            sa_print(1, "Outer PCG failed to converge after %d iterations!",
                     res.iterations)
        return res


# convenient alias matching the reference preconditioner class name
SAAMGePC = SpectralAMGSolver


class SAAMGeAlgPC:
    """Algebraic preconditioner (saamgealgpc.cpp): matrix in, V-cycle out."""

    def __init__(self, A: sp.csr_matrix, opts: Optional[SolverOptions] = None,
                 use_window: bool = False, eliminate_dof0: bool = True):
        opts = (opts or SolverOptions(theta=0.01, correct_nulspace=False)
                ).resolved()
        self.opts = opts
        self.A_full = A.tocsr()
        self.k_elim = 1 if eliminate_dof0 else 0
        Al = alg.eliminate_dof0(self.A_full) if eliminate_dof0 \
            else self.A_full
        nparts = max(Al.shape[0] // opts.first_elems_per_agg, 1)
        with TIMERS.phase("setup.partitioning"):
            self.rels = alg.create_partitioning_from_matrix(Al, nparts)
        with TIMERS.phase("setup.algebraic"):
            self.tg = alg.tg_produce_data_algebraic(
                Al, self.rels, opts.first_nu_pro, opts.nu_relax,
                opts.first_theta, smooth_interp=opts.first_nu_pro > 0,
                polynomial_coarse=0 if opts.minimal_coarse else -1,
                use_window=use_window,
                use_truncated_eigensolver=True)
        if self.k_elim:
            from saamge_jax.setup.tg import tg_augment_interp_with_identity
            tg_augment_interp_with_identity(self.tg, self.k_elim)
        from saamge_jax.setup.tg import tg_fillin_coarse_operator
        tg_fillin_coarse_operator(self.A_full, self.tg,
                                  perform_solve_init=False)
        from saamge_jax.solve.coarse import CGSolver
        self.tg.coarse_solver = CGSolver(self.tg.Ac)
        # relaxation data must match the FULL operator
        from saamge_jax.solve import smoothers
        self.tg.poly_data = smoothers.init_poly_data(
            self.A_full, opts.nu_relax, opts.smoother_poly_family,
            opts.smoother_poly_param)
        self.precond = VCycleSolver(self.tg)
        self.precond.set_operator(self.A_full)

    def mult(self, r: np.ndarray) -> np.ndarray:
        z = np.zeros_like(r)
        self.precond.mult(r, z)
        return z

    def solve(self, b: np.ndarray, x0: Optional[np.ndarray] = None,
              verbose: bool = False) -> PCGResult:
        res = pcg(self.A_full, b, self.mult, x0=x0, rel_tol=self.opts.rtol,
                  max_iter=self.opts.maxiter, verbose=verbose)
        sa_print(1, "Outer PCG %s in %d iterations.",
                 "converged" if res.converged else "did NOT converge",
                 res.iterations)
        return res
