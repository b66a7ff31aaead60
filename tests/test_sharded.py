"""Multi-device sharded solve path (the reference's pmltest invariant:
rank/device count must not change convergence) — now with DISTRIBUTED
vectors and halo-exchange operators (O(N/P) memory per device)."""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import (Mesh as JaxMesh, NamedSharding,
                          PartitionSpec as P)

from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import quad_mesh
from saamge_jax.parallel.sharded import (make_sharded_pcg,
                                         make_sharded_vcycle,
                                         shard_hierarchy, shard_vector,
                                         unshard_vector)
from saamge_jax.solve import compiled


@pytest.fixture(scope="module")
def problem():
    mesh = quad_mesh(24)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=32)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    return A, b, s


def _devices(n):
    devs = jax.devices()
    if len(devs) < n:
        devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} devices")
    return np.array(devs[:n])


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_vcycle_matches_single_device(problem, ndev):
    A, b, s = problem
    mesh = JaxMesh(_devices(ndev), axis_names=("dp",))
    h = shard_hierarchy(s.ml, mesh, dtype=jnp.float64)
    vc = make_sharded_vcycle(h)
    z = unshard_vector(h, vc(shard_vector(h, b)))

    h1 = compiled.compile_hierarchy(s.ml, dtype=jnp.float64)
    z1 = np.asarray(compiled.vcycle_apply(h1, jnp.asarray(b)))
    np.testing.assert_allclose(z, z1, rtol=1e-10, atol=1e-12)


def test_halo_ops_active(problem):
    """EVERY level's operators must take the halo path (H >= 0), not the
    all-gather fallback — this is the O(N/P)-comm contract (the RCM band
    renumbering + minrow-ordered coarse numbering guarantee it)."""
    A, b, s = problem
    mesh = JaxMesh(_devices(8), axis_names=("dp",))
    h = shard_hierarchy(s.ml, mesh, dtype=jnp.float64)
    blk = h.n0_pad // 8
    # granularity term: one agglomerate's dof span is irreducible comm
    # (hypre's halos are likewise bounded by interface/AE extent)
    ae_dofs = int(s.ml.levels[0].rels.AE_to_dof.row_sizes().max())
    bound = 3 * blk + 8 * ae_dofs
    for i, lv in enumerate(h.levels):
        for name, op in (("A", lv.A), ("P", lv.Pop), ("R", lv.Rop)):
            assert op.comm_per_apply() <= bound, (
                f"level {i} {name}: comm {op.comm_per_apply()} > {bound} "
                f"(3x fine block {blk} + 8x AE {ae_dofs})")
    lv0 = h.levels[0]
    assert lv0.A.H >= 0 and lv0.A.H <= blk
    acct = h.device_bytes()
    # per-device footprint = 1/8 of the sharded bytes + tiny replicated part
    assert acct["per_device"] < acct["sharded_total"] // 8 \
        + acct["replicated"] + 1


def test_sharded_pcg_iteration_parity(problem):
    """Same iteration count on 8 virtual devices as the host PCG —
    the pmltest serial/parallel equivalence baseline."""
    A, b, s = problem
    res_host = s.solve(b)

    mesh = JaxMesh(_devices(8), axis_names=("dp",))
    h = shard_hierarchy(s.ml, mesh, dtype=jnp.float64)
    solve = make_sharded_pcg(h, rel_tol=1e-6, max_iter=100)
    x, iters = solve(shard_vector(h, b))
    assert int(iters) == res_host.iterations
    x = unshard_vector(h, x)
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert rel < 1e-5


def test_sharded_pcg_jit_matches(problem):
    from saamge_jax.parallel.sharded import make_sharded_pcg_jit
    A, b, s = problem
    res_host = s.solve(b)
    mesh = JaxMesh(_devices(8), axis_names=("dp",))
    h = shard_hierarchy(s.ml, mesh, dtype=jnp.float64)
    solve = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=100)
    x, iters = solve(shard_vector(h, b))
    assert int(iters) == res_host.iterations
    x = unshard_vector(h, x)
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert rel < 1e-5


def test_device_count_invariance():
    """Multilevel (3-level) problem: identical iteration counts on 1, 2 and
    8 devices through the halo path (pmltest with more 'ranks')."""
    from saamge_jax.parallel.sharded import make_sharded_pcg_jit
    mesh = quad_mesh(32)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=3, correct_nulspace=False,
                         first_elems_per_agg=16, elems_per_agg=16)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    iters = []
    for ndev in (1, 2, 8):
        jmesh = JaxMesh(_devices(ndev), axis_names=("dp",))
        h = shard_hierarchy(s.ml, jmesh, dtype=jnp.float64)
        solve = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=100)
        x, its = solve(shard_vector(h, b))
        iters.append(int(its))
        x = unshard_vector(h, x)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4
    assert iters[0] == iters[1] == iters[2], iters


def test_cartesian_partitioner():
    from saamge_jax.fem.mesh import quad_mesh
    from saamge_jax.topology.part import (partition_cartesian_2d,
                                          partition_identity)
    mesh = quad_mesh(8)
    part = partition_cartesian_2d(mesh.elem_centers(), 2, 2)
    assert part.max() == 3 and np.bincount(part).tolist() == [16] * 4
    assert (partition_identity(5) == np.arange(5)).all()


def test_far_exchange_spmv_matches_scipy():
    """The packed far exchange (ParCSR offd analog): a matrix with
    deliberately long-range couplings must still produce exact SpMV
    results through the split window + packed path, with the far part
    actually engaged (far is not None) and comm volume ~ window + F."""
    import scipy.sparse as sp
    from jax import shard_map
    from saamge_jax.parallel.sharded import (_build_halo_op, _shard_op,
                                             _spmv)

    rng = np.random.default_rng(11)
    n, ndev = 256, 8
    # banded base + a handful of cross-machine couplings
    A = sp.diags([np.ones(n - 1), 3.0 * np.ones(n), np.ones(n - 1)],
                 [-1, 0, 1], format="lil")
    far_pairs = [(3, 250), (100, 7), (40, 200), (255, 0), (128, 30)]
    for i, j in far_pairs:
        A[i, j] = 0.5
        A[j, i] = 0.5
    A = A.tocsr()

    mesh = JaxMesh(_devices(ndev), axis_names=("dp",))
    op = _shard_op(_build_halo_op(A, ndev, n, n, jnp.float64), mesh)
    assert op.far is not None, "far path not engaged"
    assert op.H < n // ndev, "window should stay sub-block"
    assert op.comm_per_apply() < n // 2

    x = rng.standard_normal(n)
    xs = jax.device_put(x, NamedSharding(mesh, P("dp")))

    def body(o, xb):
        return _spmv(o, xb, "dp")

    spec_op = jax.tree_util.tree_map(lambda _: P("dp", None), op)
    y = shard_map(body, mesh=mesh, in_specs=(spec_op, P("dp")),
                  out_specs=P("dp"), check_vma=False)(op, xs)
    np.testing.assert_allclose(np.asarray(y), A @ x, rtol=1e-12)


def test_sharded_smoothed_P_matches_compiled():
    """Smoothed prolongator (nu_pro > 0, tg_smooth_interp /
    interp_smooth, interp.cpp:172): the smoothed P/R have wider
    stencils, so their halos widen — the sharded V-cycle must still
    equal the single-device compiled one and keep device-count
    invariance (the distributed story for SA-smoothed interpolation)."""
    from saamge_jax.parallel.sharded import make_sharded_pcg_jit
    mesh = quad_mesh(16)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=16, nu_pro=2,
                         first_nu_pro=2)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    assert s.ml.finest.tg_data.smooth_interp

    h1 = compiled.compile_hierarchy(s.ml, dtype=jnp.float64)
    z1 = np.asarray(compiled.vcycle_apply(h1, jnp.asarray(b)))

    iters = []
    for ndev in (1, 8):
        jmesh = JaxMesh(_devices(ndev), axis_names=("dp",))
        h = shard_hierarchy(s.ml, jmesh, dtype=jnp.float64)
        vc = make_sharded_vcycle(h)
        z = unshard_vector(h, vc(shard_vector(h, b)))
        np.testing.assert_allclose(z, z1, rtol=1e-10, atol=1e-12)
        solve = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=100)
        x, its = solve(shard_vector(h, b))
        iters.append(int(its))
        x = unshard_vector(h, x)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4
    assert iters[0] == iters[1], iters


def test_sharded_invx_smoother_matches_compiled():
    """invx family (two mixed root chains, smpr.cpp:213-234/smpr_invx):
    the sharded V-cycle must equal the single-device compiled one, and
    PCG with the invx smoother must keep device-count invariance."""
    from saamge_jax.parallel.sharded import make_sharded_pcg_jit
    mesh = quad_mesh(16)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=16, nu_relax=3,
                         smoother_poly_family="invx",
                         smoother_poly_param=0.1)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    pd = s.ml.levels[0].tg_data.poly_data
    assert pd.roots2 is not None and len(pd.roots2) == 2  # nu-1 roots

    h1 = compiled.compile_hierarchy(s.ml, dtype=jnp.float64)
    z1 = np.asarray(compiled.vcycle_apply(h1, jnp.asarray(b)))

    iters = []
    for ndev in (1, 8):
        jmesh = JaxMesh(_devices(ndev), axis_names=("dp",))
        h = shard_hierarchy(s.ml, jmesh, dtype=jnp.float64)
        vc = make_sharded_vcycle(h)
        z = unshard_vector(h, vc(shard_vector(h, b)))
        np.testing.assert_allclose(z, z1, rtol=1e-10, atol=1e-12)
        solve = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=100)
        x, its = solve(shard_vector(h, b))
        iters.append(int(its))
        x = unshard_vector(h, x)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4
    assert iters[0] == iters[1], iters
