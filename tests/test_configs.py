"""Coverage of the BASELINE.json benchmark configurations beyond the
reference's ctest set: 3D elasticity, high-contrast jump coefficients."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh, quad_mesh


def test_elasticity_3d_rbm_kernel():
    """3D elasticity element matrices: 6 rigid body modes in the kernel."""
    mesh = hex_mesh(3)
    em = assemble.elasticity_element_matrices(mesh, 1.0)
    E = em[0]
    w = np.linalg.eigvalsh(E)
    assert (np.abs(w[:6]) < 1e-10 * abs(w[-1])).all()
    assert w[6] > 1e-8 * abs(w[-1])


def test_elasticity_3d_solver():
    mesh = hex_mesh(6)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, elasticity=True)
    b = assemble.domain_lf(mesh, 1.0, 1, mesh.dim)
    b[ess_dofs] = 0.0
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=32, linear_coarse=True)
    s = SpectralAMGSolver(A, mesh, em, opts, vdim=mesh.dim,
                          ess_attr_marker=ess)
    res = s.solve(b)
    assert res.converged and res.iterations <= 25
    err = np.linalg.norm(res.x - spla.spsolve(A.tocsc(), b))
    assert err < 1e-5 * max(np.linalg.norm(res.x), 1.0)


def test_high_contrast_inclusions_robust():
    """Random high-contrast inclusions (1e6 jumps): the spectral coarse
    space must keep PCG iterations bounded (the raison d'etre of spectral
    AMGe — README:7-8)."""
    rng = np.random.default_rng(42)
    mesh = quad_mesh(48)
    inclusion = rng.random(mesh.num_elements) < 0.2
    coefs = np.where(inclusion, 1e6, 1.0)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(theta=0.003, num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=64)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    res = s.solve(b)
    assert res.converged
    assert res.iterations <= 25, res.iterations
    err = np.linalg.norm(res.x - spla.spsolve(A.tocsc(), b))
    assert err < 1e-4


def test_debug_ladder_sa_assert():
    """sa_assert (SA_ASSERT ladder analog, common.hpp:598-656): callables
    are only evaluated at or above their ladder level; failures raise."""
    from saamge_jax.config import CONFIG
    from saamge_jax.utils.logging import sa_assert

    calls = []
    old = CONFIG.debug_level
    try:
        CONFIG.debug_level = 5
        sa_assert(7, lambda: calls.append(1) or False, "skipped")
        assert calls == []          # expensive check not evaluated
        CONFIG.debug_level = 7
        sa_assert(7, lambda: calls.append(1) or True, "passes")
        assert calls == [1]
        with pytest.raises(AssertionError, match="boom"):
            sa_assert(7, False, "boom")
    finally:
        CONFIG.debug_level = old


def test_debug_ladder_setup_invariants_run_clean():
    """At debug_level 7 the expensive setup invariants (MIS partition,
    RAP symmetry, tent-P orthonormality) all pass on a healthy problem."""
    from saamge_jax.config import CONFIG

    old = CONFIG.debug_level
    try:
        CONFIG.debug_level = 7
        mesh = quad_mesh(12)
        ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        A, b, em, _, _ = assemble.build_discrete_problem(
            mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
        opts = SolverOptions(num_levels=2, correct_nulspace=False,
                             elems_per_agg=16)
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
        res = s.solve(b)
        assert res.converged
    finally:
        CONFIG.debug_level = old
