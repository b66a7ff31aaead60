"""Adaptivity: xbad probing, subspace enrichment, and double cycle."""

import numpy as np
import pytest

from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import quad_mesh
from saamge_jax.setup.adapt import adapt_approx_xbad, tg_adapt


def _anisotropic_problem(n=24, eps=1e-3):
    """Strongly anisotropic diffusion — hard for a small coarse space."""
    mesh = quad_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    mat = np.array([[1.0, 0.0], [0.0, eps]])
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=mat, rhs=1.0, ess_attr_marker=ess)
    return mesh, ess, A, b, em


def test_tg_adapt_enrichment_improves_cf():
    mesh, ess, A, b, em = _anisotropic_problem()
    # deliberately weak coarse space: tiny theta
    opts = SolverOptions(theta=1e-5, num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=32)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    level = s.ml.finest
    tg = level.tg_data

    xbad = np.random.default_rng(3).standard_normal(A.shape[0])
    _, pre = adapt_approx_xbad(A, tg, 8, xbad.copy(), normalize=True)

    dim_before = tg.interp.shape[1]
    stats = tg_adapt(A, tg, level.rels, tg.elem_data, probe_iters=8)
    dim_after = tg.interp.shape[1]
    assert dim_after >= dim_before

    xbad2 = np.random.default_rng(3).standard_normal(A.shape[0])
    _, post = adapt_approx_xbad(A, tg, 8, xbad2, normalize=True)
    # enrichment must improve the asymptotic convergence factor
    assert post["acf"] <= pre["acf"] + 1e-12
    assert post["acf"] < 0.995


def test_double_cycle_converges():
    mesh = quad_mesh(40)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=3, correct_nulspace=True,
                         double_cycle=True, first_elems_per_agg=32,
                         elems_per_agg=8)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    res = s.solve(b)
    assert res.converged
    assert res.iterations <= 20
    import scipy.sparse.linalg as spla
    err = np.linalg.norm(res.x - spla.spsolve(A.tocsc(), b))
    assert err < 1e-5


def test_w_cycle_converges_at_least_as_fast():
    from saamge_jax.solve.pcg import pcg
    from saamge_jax.solve.vcycle import VCycleSolver
    mesh = quad_mesh(40)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=3, correct_nulspace=False,
                         first_elems_per_agg=32, elems_per_agg=8)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    res_v = s.solve(b)

    w = VCycleSolver(s.ml.finest.tg_data, mu=2)
    w.set_operator(A)

    def mult(r):
        z = np.zeros_like(r)
        w.mult(r, z)
        return z

    res_w = pcg(A, b, mult, rel_tol=1e-6, max_iter=100)
    assert res_w.converged
    assert res_w.iterations <= res_v.iterations


def test_double_cycle_symmetric_and_beats_reference_literal():
    """Weak-spot check from round 1: our DoubleCycle accumulates the
    out-in-out corrections (symmetrized multiplicative composition,
    error propagator (I-BoA)(I-BiA)(I-BoA)); the reference's literal
    code overwrites XC between stages (DoubleCycle.cpp:81-95), so its
    final coarse correction is only the LAST outer solve applied to a
    twice-updated residual — the first two solves are discarded.  Verify
    (a) our composed preconditioner is symmetric (PCG-safe), (b) on the
    coarse level it contracts at least as well as the literal variant."""
    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=3, correct_nulspace=True,
                         double_cycle=True, first_elems_per_agg=32,
                         elems_per_agg=8)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    dc = s.precond
    Ac = dc.Ac.toarray()
    nc = Ac.shape[0]

    def ours(rc):
        xc = np.zeros(nc)
        dc.outer.mult(rc, xc)
        corr = np.zeros_like(xc)
        dc.inner.mult(rc - Ac @ xc, corr)
        xc = xc + corr
        corr = np.zeros_like(xc)
        dc.outer.mult(rc - Ac @ xc, corr)
        return xc + corr

    def literal(rc):
        xc = np.zeros(nc)
        dc.outer.mult(rc, xc)
        r2 = rc - Ac @ xc
        xc2 = np.zeros(nc)
        dc.inner.mult(r2, xc2)
        r3 = r2 - Ac @ xc2
        xc3 = np.zeros(nc)
        dc.outer.mult(r3, xc3)
        return xc3

    # (a) symmetry of the composed coarse preconditioner
    B = np.column_stack([ours(e) for e in np.eye(nc)])
    assert np.abs(B - B.T).max() <= 1e-8 * np.abs(B).max()

    # (b) error contraction ||I - B Ac|| via a few random vectors
    rng = np.random.default_rng(0)
    ratios_ours, ratios_lit = [], []
    for _ in range(5):
        e = rng.standard_normal(nc)
        r = Ac @ e
        eo = e - ours(r)
        el = e - literal(r)
        en = np.sqrt(e @ (Ac @ e))
        ratios_ours.append(np.sqrt(max(eo @ (Ac @ eo), 0.0)) / en)
        ratios_lit.append(np.sqrt(max(el @ (Ac @ el), 0.0)) / en)
    assert max(ratios_ours) <= max(ratios_lit) + 1e-10
