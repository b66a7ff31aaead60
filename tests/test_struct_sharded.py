"""Sharded structured fast path vs the single-device structured solve.

The pmltest invariant (reference amg/CMakeLists.txt:198-203) on the
gather-free brick hierarchy: sharding over an x-slab mesh must not
change the preconditioner — identical V-cycle output (the per-row
arithmetic is the same kernels over the same data) and identical PCG
iteration counts on 1..8 devices."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.topology.part import partition_cartesian_3d
from saamge_jax.solve.structured import (BrickGeometry, compile_structured,
                                         struct_pcg_solve,
                                         struct_vcycle_apply)
from saamge_jax.parallel.structured_sharded import (
    gather_fine, make_struct_sharded_pcg, make_struct_sharded_vcycle,
    scatter_fine, shard_structured)


def _setup(n=8, nb=4, num_levels=3):
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(5)
    coefs = 10.0 ** rng.uniform(-1.0, 1.0, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    opts = SolverOptions(num_levels=num_levels, correct_nulspace=False,
                         device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part)
    geo = BrickGeometry((nb, nb, nb), (n // nb,) * 3)
    return s, A, b, geo


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_struct_vcycle_matches_single(ndev):
    s, A, b, geo = _setup(8, 4, 3)
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_format="brickblock")
    y_ref = np.asarray(struct_vcycle_apply(h, jnp.asarray(b, jnp.float32)))

    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    hs = shard_structured(h, mesh)
    bsh = scatter_fine(hs, b)
    vc = make_struct_sharded_vcycle(hs)
    y = gather_fine(hs, vc(bsh))
    assert np.abs(y - y_ref).max() <= 1e-5 * max(np.abs(y_ref).max(),
                                                 1e-30)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_struct_pcg_device_count_invariant(ndev):
    if len(jax.devices("cpu")) < ndev:
        pytest.skip("needs virtual device mesh")
    s, A, b, geo = _setup(8, 8, 3)   # brick=1 so BX=8 divides every ndev
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_format="brickblock")
    _, it_ref, _ = struct_pcg_solve(h, jnp.asarray(b, jnp.float32),
                                    max_iter=80)

    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    hs = shard_structured(h, mesh)
    bsh = scatter_fine(hs, b)
    solve = make_struct_sharded_pcg(hs, rel_tol=1e-6, max_iter=80)
    x, it = solve(bsh)
    assert int(it) == int(it_ref), (int(it), int(it_ref))
    xh = gather_fine(hs, x)
    rel = np.linalg.norm(b - A @ xh) / np.linalg.norm(b)
    assert rel < 1e-4, rel


@pytest.mark.parametrize("ndev", [4])
def test_sharded_struct_bf16_twins_match_single(ndev):
    """The flagship dtype configuration (bf16 smoother twin + bf16 mid
    blocks + bf16 tent blocks) shards with the same per-row arithmetic:
    sharded V-cycle equals the single-chip bf16 V-cycle."""
    s, A, b, geo = _setup(8, 4, 3)
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_format="brickblock",
                           mid_dtype=jnp.bfloat16,
                           smoother_dtype=jnp.bfloat16,
                           rp_dtype=jnp.bfloat16)
    y_ref = np.asarray(struct_vcycle_apply(h, jnp.asarray(b, jnp.float32)))

    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    hs = shard_structured(h, mesh)
    assert hs.vals0s is not None
    assert hs.vals0s.dtype == jnp.bfloat16
    assert hs.blocks1.dtype == jnp.bfloat16
    bsh = scatter_fine(hs, b)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bsh))
    assert np.abs(y - y_ref).max() <= 1e-5 * max(np.abs(y_ref).max(),
                                                 1e-30)
    _, it_ref, _ = struct_pcg_solve(h, jnp.asarray(b, jnp.float32),
                                    max_iter=80)
    x, it = make_struct_sharded_pcg(hs, max_iter=80)(bsh)
    assert int(it) == int(it_ref), (int(it), int(it_ref))


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_struct_distributed_mid_default(ndev):
    """The bf16 configuration DISTRIBUTES the mid level — blocks/dinv1
    sharded by brick-x layer, O(N1/P) per-device mid bytes — and its
    per-root chained loop matches the single-device chain (same
    per-element arithmetic; halo bricks equal interior bricks), so
    V-cycle equality is tight and iteration counts match."""
    from saamge_jax.parallel.structured_sharded import mid_bytes_per_device
    s, A, b, geo = _setup(8, 4, 3)
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_format="brickblock",
                           mid_dtype=jnp.bfloat16,
                           smoother_dtype=jnp.bfloat16,
                           rp_dtype=jnp.bfloat16)
    bdev = jnp.asarray(b, jnp.float32)
    y_ref = np.asarray(struct_vcycle_apply(h, bdev))
    _, it_ref, _ = struct_pcg_solve(h, bdev, max_iter=80)

    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    hs = shard_structured(h, mesh)
    acct = mid_bytes_per_device(hs)
    total_mid = h.A1d.nbytes + h.dinv1.size * h.dinv1.dtype.itemsize \
        + h.R1.size * h.R1.dtype.itemsize
    assert acct["sharded"] <= total_mid // ndev + total_mid // 8, \
        (acct, total_mid)
    bsh = scatter_fine(hs, b)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bsh))
    assert np.abs(y - y_ref).max() <= 1e-5 * max(np.abs(y_ref).max(),
                                                 1e-30)
    x, it = make_struct_sharded_pcg(hs, max_iter=80)(bsh)
    assert int(it) == int(it_ref), (int(it), int(it_ref))
    xh = gather_fine(hs, x)
    rel = np.linalg.norm(b - A @ xh) / np.linalg.norm(b)
    assert rel < 1e-4, rel


@pytest.mark.parametrize("ndev", [2])
def test_production_regime_sharded(ndev):
    """The flagship-configuration sharded check (full bf16 + superbrick
    coarsest) as a SUITE regression — shared implementation with the
    dryrun (saamge_jax/parallel/checks.py), run here at a smaller
    size."""
    from saamge_jax.parallel.checks import production_regime_sharded_check
    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    out = production_regime_sharded_check(mesh, ns=24, brick=3)
    assert out["iters"] == out["iters_ref"]


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_struct_superbrick_coarsest(ndev):
    """Superbrick (structured block-diagonal) coarsest restriction,
    DISTRIBUTED: the level-2 tent blocks shard by flat superbrick
    chunks (_mid_coarsest_sb) with identical per-superbrick arithmetic
    to the single-device mid_apply_R1/P1, so parity is exact."""
    from saamge_jax.topology.part import partition_cartesian_bricks
    n, nb = 8, 4
    mesh_h = hex_mesh(n)
    ess = np.ones(mesh_h.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(5)
    coefs = 10.0 ** rng.uniform(-1.0, 1.0, mesh_h.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh_h, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh_h.elem_centers(), nb, nb, nb)
    supers = (2, 2, 2)
    override = lambda i: partition_cartesian_bricks(  # noqa: E731
        (nb,) * 3, supers)
    s = SpectralAMGSolver(
        A, mesh_h, em,
        SolverOptions(num_levels=3, correct_nulspace=False,
                      device_setup=False),
        ess_attr_marker=ess, partitioning=part,
        coarse_part_override=override)
    geo = BrickGeometry((nb,) * 3, (n // nb,) * 3)
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_format="brickblock",
                           super_bricks=supers, rp_dtype=jnp.bfloat16)
    assert h.Rst1 is not None
    bdev = jnp.asarray(b, jnp.float32)
    y_ref = np.asarray(struct_vcycle_apply(h, bdev))
    _, it_ref, _ = struct_pcg_solve(h, bdev, max_iter=80)

    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    hs = shard_structured(h, mesh)
    assert hs.rst1 is not None, "superbrick coarsest must distribute"
    bsh = scatter_fine(hs, b)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bsh))
    assert np.abs(y - y_ref).max() <= 1e-5 * max(np.abs(y_ref).max(),
                                                 1e-30)
    x, it = make_struct_sharded_pcg(hs, max_iter=80)(bsh)
    assert int(it) == int(it_ref), (int(it), int(it_ref))
