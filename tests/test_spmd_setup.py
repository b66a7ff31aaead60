"""SPMD-decomposed setup (parallel/spmd_setup.py): rank-local index
plumbing + explicit exchanges must reproduce the single-host hierarchy
for every rank count (the pmltest serial/parallel-equivalence invariant,
reference CMakeLists.txt:198-203), with per-rank memory that scales down
and cross-rank traffic bounded by the interface size."""

import numpy as np
import pytest

from saamge_jax.api import bdr_dof_flags
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh, quad_mesh
from saamge_jax.parallel.spmd_setup import (assemble_global_A, spmd_coarsen,
                                            spmd_ml_produce_data)
from saamge_jax.setup import tg as tg_mod
from saamge_jax.setup.elmat import GeometricProvider
from saamge_jax.setup.ml import MultilevelParameters
from saamge_jax.solve.pcg import pcg
from saamge_jax.solve.vcycle import VCycleSolver
from saamge_jax.topology.agglomerate import create_partitioning_fine
from saamge_jax.topology.part import partition_cartesian_3d


@pytest.fixture(scope="module")
def problem3d():
    n = 12
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(3)
    coefs = 10.0 ** rng.uniform(-2, 2, mesh.num_elements)
    A, b, em, e2d, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    flags = bdr_dof_flags(mesh, ess)
    e2e = mesh.elem_to_elem()
    part = partition_cartesian_3d(mesh.elem_centers(), 3, 3, 3)
    return mesh, A, b, em, e2d, e2e, flags, part


def _pcg_iters(A, b, P, Ac, nu_relax=3, theta=0.05):
    tg = tg_mod.TGData(
        interp_data=None, poly_data=None, theta=theta, smooth_interp=False)
    from saamge_jax.solve import smoothers
    from saamge_jax.solve.coarse import make_coarse_solver
    tg.poly_data = smoothers.init_poly_data(A, nu_relax, "sas")
    tg.tent_interp = P.tocsr()
    tg.interp = P.tocsr()
    tg.restr = P.T.tocsr()
    tg.Ac = Ac.tocsr()
    tg.coarse_solver = make_coarse_solver(tg.Ac, "direct")
    sol = VCycleSolver(tg)
    sol.set_operator(A)

    def prec(r):
        z = np.zeros_like(r)
        sol.mult(r, z)
        return z

    return pcg(A, b, prec, rel_tol=1e-6, max_iter=200).iterations


def test_spmd_matches_serial_two_level(problem3d):
    """Projector, coarse-dof counts, distributed RAP, and PCG iterations
    all match the single-host setup for 1/2/4/8 ranks."""
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    theta = 0.05
    rels = create_partitioning_fine(A, e2d, e2e, part.copy(), flags, 27)
    emp = GeometricProvider(rels, A, em)
    tg = tg_mod.tg_produce_data(A, rels, 0, 3, emp, theta, False)
    tg_mod.tg_update_coarse_operator(A, tg, perform_solve_init=False)
    P_s, Ac_s = tg.tent_interp, tg.Ac
    G_s = (P_s @ P_s.T).toarray()
    it_s = _pcg_iters(A, b, P_s, Ac_s, theta=theta)

    for R in (1, 2, 4, 8):
        out = spmd_coarsen(e2d, e2e, em, flags, R,
                           partitioning=part.copy(), theta=theta,
                           use_truncated=False)
        assert out.P.shape == P_s.shape
        assert np.array_equal(out.mis_numcoarsedof,
                              tg.interp_data.mis_numcoarsedof)
        # span equality per MIS (P columns may rotate within a MIS block
        # under 1-ulp assembly-order differences; the projector is the
        # rotation-invariant object)
        G_d = (out.P @ out.P.T).toarray()
        assert np.abs(G_s - G_d).max() < 1e-10
        # the distributed Galerkin product equals the controller product
        ref = (out.P.T @ A @ out.P).tocsr()
        assert abs(out.Ac - ref).max() <= 1e-12 * abs(ref).max()
        assert out.Ac.nnz == ref.nnz
        assert _pcg_iters(A, b, out.P, out.Ac, theta=theta) == it_s


def test_spmd_assembled_A_matches_global(problem3d):
    """Owner-row gather of the rank-local operators reproduces the global
    BC-eliminated matrix (values and pattern)."""
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    out = spmd_coarsen(e2d, e2e, em, flags, 4, partitioning=part.copy(),
                       theta=0.05, use_truncated=False)
    Ag = assemble_global_A(out)
    assert Ag.shape == A.shape
    d = abs(Ag - A).max()
    assert d <= 1e-10 * abs(A).max(), d


def test_spmd_rank_count_invariance(problem3d):
    """Same MIS structure, coarse dimensions, and iteration counts
    independent of the rank count (determinism contract)."""
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    outs = [spmd_coarsen(e2d, e2e, em, flags, R, partitioning=part.copy(),
                         theta=0.05, use_truncated=False)
            for R in (1, 8)]
    assert outs[0].num_mises == outs[1].num_mises
    assert np.array_equal(outs[0].mis_numcoarsedof,
                          outs[1].mis_numcoarsedof)
    G0 = (outs[0].P @ outs[0].P.T).toarray()
    G1 = (outs[1].P @ outs[1].P.T).toarray()
    assert np.abs(G0 - G1).max() < 1e-10


def test_spmd_memory_and_traffic_scale(problem3d):
    """Per-rank peak bytes shrink with the rank count; per-rank exchange
    volume stays a small fraction of the per-rank problem bytes."""
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    out1 = spmd_coarsen(e2d, e2e, em, flags, 1, partitioning=part.copy(),
                        theta=0.05, use_truncated=False)
    out8 = spmd_coarsen(e2d, e2e, em, flags, 8, partitioning=part.copy(),
                        theta=0.05, use_truncated=False)
    peak1 = max(out1.peak_bytes_per_rank)
    peak8 = max(out8.peak_bytes_per_rank)
    assert peak8 < 0.45 * peak1, (peak8, peak1)
    # halo-class exchanges are interface-bound.  At this deliberately tiny
    # mesh (12^3 elements over 8 ranks) interface ~ volume, so the bound
    # is loose; the scaling claim is that the exchange stays under the
    # rank-local state, while at production sizes it shrinks as N^{2/3}.
    led = out8.ledger.summary()
    assert led["assembly_halo"]["max_rank_bytes"] < peak8, led
    for phase in ("sec_reduce", "sec_broadcast",
                  "rap_ghost_rows", "dof_ae_union"):
        if phase in led:
            assert led[phase]["max_rank_bytes"] < 0.5 * peak8, (
                phase, led[phase], peak8)


def test_spmd_three_level_matches_serial(problem3d):
    """Full MLData via spmd_ml_produce_data: identical coarse dimensions
    and PCG iterations as the single-host ml_produce_data with the same
    parameters (kway seeds included)."""
    from saamge_jax.setup.ml import ml_produce_data
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    mlp_kwargs = dict(num_coarsenings=2, nparts_arr=[27, 4],
                      first_theta=0.05, theta=0.05,
                      use_correct_nullspace=False)
    rels = create_partitioning_fine(A, e2d, e2e, part.copy(), flags, 27)
    emp = GeometricProvider(rels, A, em)
    ml_s = ml_produce_data(A, rels, emp,
                           MultilevelParameters(**mlp_kwargs))
    ml_d, out = spmd_ml_produce_data(
        e2d, e2e, em, flags, 8, MultilevelParameters(**mlp_kwargs),
        A=A, partitioning=part.copy())
    dims_s = [l.tg_data.Ac.shape[0] for l in ml_s.levels]
    dims_d = [l.tg_data.Ac.shape[0] for l in ml_d.levels]
    assert dims_s == dims_d

    def iters(ml):
        sol = VCycleSolver(ml.levels[0].tg_data)
        sol.set_operator(A)

        def prec(r):
            z = np.zeros_like(r)
            sol.mult(r, z)
            return z

        return pcg(A, b, prec, rel_tol=1e-6, max_iter=200).iterations

    assert iters(ml_d) == iters(ml_s)


def test_spmd_local_partitioner_2d():
    """Without a global partitioning each rank runs the local k-way
    partitioner (the per-rank METIS model); the hierarchy must still
    converge at AMG-grade iteration counts."""
    n = 16
    mesh = quad_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, e2d, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    flags = bdr_dof_flags(mesh, ess)
    e2e = mesh.elem_to_elem()
    out = spmd_coarsen(e2d, e2e, em, flags, 4, partitioning=None,
                       elems_per_agg=16, theta=0.003, use_truncated=False)
    assert out.P.shape[0] == A.shape[0]
    assert 0 < out.P.shape[1] < A.shape[0]
    it = _pcg_iters(A, b, out.P, out.Ac, theta=0.003)
    assert it <= 12, it


def test_spmd_device_mesh_compute(problem3d):
    """setup_mesh: rank-major batched eigensolves + mesh-sharded
    owner-computes MIS-SVD produce the same coarse DIMENSIONS as the
    host-compute SPMD path (f32 device solves may rotate borderline-free
    bases; dimensions and convergence are the invariants)."""
    import jax
    from jax.sharding import Mesh
    mesh_, A, b, em, e2d, e2e, flags, part = problem3d
    devs = np.array(jax.devices("cpu")[:8])
    mesh = Mesh(devs, axis_names=("dp",))
    out_h = spmd_coarsen(e2d, e2e, em, flags, 8, partitioning=part.copy(),
                         theta=0.05, use_truncated=False)
    out_d = spmd_coarsen(e2d, e2e, em, flags, 8, partitioning=part.copy(),
                         theta=0.05, use_truncated=False, setup_mesh=mesh)
    assert out_d.P.shape == out_h.P.shape
    assert out_d.num_mises == out_h.num_mises
    it = _pcg_iters(A, b, out_d.P, out_d.Ac, theta=0.05)
    it_h = _pcg_iters(A, b, out_h.P, out_h.Ac, theta=0.05)
    assert it <= it_h + 1, (it, it_h)


def test_spmd_smoothed_prolongator(problem3d):
    """Distributed interp smoothing (ghost-P-row halo per root) matches
    the single-host interp_smooth applied to the same tentative P, and
    the distributed RAP uses the smoothed rows."""
    from saamge_jax.setup.interp import interp_smooth
    from saamge_jax.solve.smoothers import sa_poly_roots, weighted_l1_dinv
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    nu = 2
    out = spmd_coarsen(e2d, e2e, em, flags, 8, partitioning=part.copy(),
                       theta=0.05, use_truncated=False, nu_pro=nu)
    assert out.interp is not None
    ref = interp_smooth(A, out.P, weighted_l1_dinv(A), sa_poly_roots(nu))
    d = abs(out.interp - ref).max() / abs(ref).max()
    assert d < 1e-12, d
    rap_ref = (ref.T @ A @ ref).tocsr()
    d2 = abs(out.Ac - rap_ref).max() / abs(rap_ref).max()
    assert d2 < 1e-11, d2
    # smoothed-P hierarchy converges at least as fast as tentative
    it_s = _pcg_iters(A, b, out.interp, out.Ac, theta=0.05)
    assert it_s <= 20, it_s


def test_spmd_mldata_compiles_to_device(problem3d):
    """The SPMD-built MLData drives the jitted device solve path
    (solve/compiled.py) with host-iteration parity."""
    import jax.numpy as jnp
    from saamge_jax.solve import compiled
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    mlp = MultilevelParameters(num_coarsenings=2, nparts_arr=[27, 4],
                               first_theta=0.05, theta=0.05,
                               use_correct_nullspace=False)
    ml, out = spmd_ml_produce_data(e2d, e2e, em, flags, 8, mlp, A=A,
                                   partitioning=part.copy())
    h = compiled.compile_hierarchy(ml, dtype=jnp.float32)
    x, it, _ = compiled.pcg_solve(h, jnp.asarray(b, jnp.float32),
                                  rel_tol=1e-6, max_iter=100)
    xh = np.asarray(x, np.float64)
    rel = np.linalg.norm(b - A @ xh) / np.linalg.norm(b)
    assert rel < 1e-4, rel

    sol = VCycleSolver(ml.levels[0].tg_data)
    sol.set_operator(A)

    def prec(r):
        z = np.zeros_like(r)
        sol.mult(r, z)
        return z

    it_h = pcg(A, b, prec, rel_tol=1e-6, max_iter=100).iterations
    assert abs(int(it) - it_h) <= 1, (int(it), it_h)


def test_spmd_hierarchy_reuse_after_matrix_change(problem3d):
    """adapt_update_operators on an SPMD-built MLData (the threeleveladapt
    hierarchy-reuse pattern, reference adapt.cpp:189): same coarse bases,
    refreshed Dinv/RAP after A <- A + I."""
    import scipy.sparse as sps
    from saamge_jax.setup.adapt import adapt_update_operators_ml
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    mlp = MultilevelParameters(num_coarsenings=2, nparts_arr=[27, 4],
                               first_theta=0.05, theta=0.05,
                               use_correct_nullspace=False)
    ml, out = spmd_ml_produce_data(e2d, e2e, em, flags, 4, mlp, A=A,
                                   partitioning=part.copy())
    A2 = (A + sps.identity(A.shape[0], format="csr")).tocsr()
    adapt_update_operators_ml(A2, ml, mlp)

    sol = VCycleSolver(ml.levels[0].tg_data)
    sol.set_operator(A2)

    def prec(r):
        z = np.zeros_like(r)
        sol.mult(r, z)
        return z

    res = pcg(A2, b, prec, rel_tol=1e-6, max_iter=50)
    assert res.converged and res.iterations <= 15, res.iterations


def test_spmd_recursive_coarsenings(problem3d):
    """spmd_coarsenings=2: BOTH coarsenings rank-decomposed (coarse
    elements = fine AEs on their ranks, local AE assembly from ragged
    coarse element matrices, operator rows from the distributed RAP).
    The recursed distributed RAP matches the controller triple product
    and the hierarchy solves at AMG-grade iteration counts."""
    from saamge_jax.parallel.spmd_setup import spmd_coarsen_from
    mesh, A, b, em, e2d, e2e, flags, part = problem3d
    out0 = spmd_coarsen(e2d, e2e, em, flags, 4, partitioning=part.copy(),
                        theta=0.05, use_truncated=False)
    out1 = spmd_coarsen_from(out0, theta=0.05, nparts=4,
                             use_truncated=False)
    ref = (out1.P.T @ out0.Ac @ out1.P).tocsr()
    assert abs(out1.Ac - ref).max() <= 1e-12 * abs(ref).max()
    assert out1.Ac.nnz == ref.nnz

    mlp = MultilevelParameters(num_coarsenings=2, nparts_arr=[27, 4],
                               first_theta=0.05, theta=0.05,
                               use_correct_nullspace=False)
    ml, _ = spmd_ml_produce_data(e2d, e2e, em, flags, 4, mlp, A=A,
                                 partitioning=part.copy(),
                                 spmd_coarsenings=2)
    assert len(ml.levels) == 2
    sol = VCycleSolver(ml.levels[0].tg_data)
    sol.set_operator(A)

    def prec(r):
        z = np.zeros_like(r)
        sol.mult(r, z)
        return z

    res = pcg(A, b, prec, rel_tol=1e-6, max_iter=50)
    assert res.converged and res.iterations <= 10, res.iterations


def test_spmd_setup_feeds_sharded_solve(problem3d):
    """End-to-end distributed story: SPMD (rank-decomposed) setup ->
    sharded halo-exchange solve over the 8-device mesh, with iteration
    parity against the single-device compiled path."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from saamge_jax.parallel.sharded import (make_sharded_pcg_jit,
                                             shard_hierarchy, shard_vector,
                                             unshard_vector)
    from saamge_jax.solve import compiled
    mesh_, A, b, em, e2d, e2e, flags, part = problem3d
    mlp = MultilevelParameters(num_coarsenings=1, nparts_arr=[27],
                               first_theta=0.05, theta=0.05,
                               use_correct_nullspace=False)
    ml, out = spmd_ml_produce_data(e2d, e2e, em, flags, 8, mlp, A=A,
                                   partitioning=part.copy())
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("dp",))
    h = shard_hierarchy(ml, mesh, dtype=jnp.float32)
    solve = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=60)
    x, it = solve(shard_vector(h, b))
    xh = unshard_vector(h, x)
    rel = np.linalg.norm(b - A @ xh) / np.linalg.norm(b)
    assert rel < 1e-4, rel
    hc = compiled.compile_hierarchy(ml, dtype=jnp.float32)
    _, it1, _ = compiled.pcg_solve(hc, jnp.asarray(b, jnp.float32),
                                   rel_tol=1e-6, max_iter=60)
    assert int(it) == int(it1), (int(it), int(it1))


def test_spmd_high_order_and_elasticity():
    """The SPMD pipeline is discretization-agnostic: order-2 scalar FEM
    and vector-valued (2D elasticity, byVDIM) problems go through the
    same rank-decomposed path with distributed-RAP exactness and
    AMG-grade convergence."""
    n = 10
    mesh = quad_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)

    # order-2 scalar
    A2, b2, em2, e2d2, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, order=2)
    fl2 = bdr_dof_flags(mesh, ess, order=2)
    e2e = mesh.elem_to_elem()
    out = spmd_coarsen(e2d2, e2e, em2, fl2, 4, partitioning=None,
                       elems_per_agg=25, theta=0.003, use_truncated=False)
    ref = (out.P.T @ A2 @ out.P).tocsr()
    assert abs(out.Ac - ref).max() <= 1e-12 * abs(ref).max()
    assert _pcg_iters(A2, b2, out.P, out.Ac, theta=0.003) <= 15

    # 2D elasticity (vector dofs, byVDIM)
    Ae, be, eme, e2de, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, elasticity=True)
    fle = bdr_dof_flags(mesh, ess, order=1, vdim=mesh.dim)
    oute = spmd_coarsen(e2de, e2e, eme, fle, 4, partitioning=None,
                        elems_per_agg=25, theta=0.01, use_truncated=False)
    refe = (oute.P.T @ Ae @ oute.P).tocsr()
    assert abs(oute.Ac - refe).max() <= 1e-12 * abs(refe).max()
    be2 = np.random.default_rng(0).standard_normal(Ae.shape[0])
    ess_dofs = np.flatnonzero(fle & 1)
    be2[ess_dofs] = 0.0
    assert _pcg_iters(Ae, be2, oute.P, oute.Ac, theta=0.01) <= 25
