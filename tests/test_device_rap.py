"""Device structured RAP (setup/device_rap.py) vs the host scipy
Galerkin product (tg.py tg_coarse_matr; reference hypre RAP,
tg.hpp:696)."""

import numpy as np
import pytest

import jax.numpy as jnp

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.topology.part import partition_cartesian_3d
from saamge_jax.setup.device_rap import (make_structured_rap_override,
                                         structured_rap)
from saamge_jax.solve.structured import BrickGeometry


def _problem(n, nbs, num_levels=2, coefs=None):
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    if coefs is None:
        rng = np.random.default_rng(11)
        coefs = 10.0 ** rng.uniform(-1, 1, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), *nbs)
    opts = SolverOptions(num_levels=num_levels, correct_nulspace=False,
                         elems_per_agg=4, device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part)
    geo = BrickGeometry(nbs, tuple(n // k for k in nbs))
    return s, A, b, geo


@pytest.mark.parametrize("nbs", [(2, 2, 2), (2, 4, 1)])
def test_device_rap_matches_host(nbs):
    """Ac from the device window contractions equals interp.T A interp
    (same sparsity, f32-representation-level values)."""
    s, A, b, geo = _problem(8, nbs)
    lv0 = s.ml.levels[0]
    tg0 = lv0.tg_data
    assert not tg0.smooth_interp
    Ac_host = tg0.Ac.tocsr()
    Ac_dev = structured_rap(lv0.A.tocsr(), lv0.rels,
                            tg0.tent_interp.tocsr(),
                            tg0.interp_data.mis_numcoarsedof, geo)
    assert Ac_dev.shape == Ac_host.shape
    d = abs(Ac_dev - Ac_host).max()
    assert d <= 1e-5 * abs(Ac_host).max(), d
    # identical nonzero pattern (padding zeros eliminated)
    assert Ac_dev.nnz == Ac_host.nnz


def test_rap_override_end_to_end():
    """Full solver built with rap_override converges with the same
    iteration count as the host-RAP hierarchy."""
    mesh = hex_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(3)
    coefs = 10.0 ** rng.uniform(-1, 1, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         elems_per_agg=4, device_setup=False)
    geo = BrickGeometry((2, 2, 2), (4, 4, 4))
    s_host = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                               partitioning=part)
    s_dev = SpectralAMGSolver(
        A, mesh, em, opts, ess_attr_marker=ess, partitioning=part,
        rap_override=make_structured_rap_override(geo))
    d = abs(s_dev.ml.levels[0].tg_data.Ac
            - s_host.ml.levels[0].tg_data.Ac).max()
    assert d <= 1e-5 * abs(s_host.ml.levels[0].tg_data.Ac).max()
    r_host = s_host.solve(b)
    r_dev = s_dev.solve(b)
    assert r_dev.iterations == r_host.iterations


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_rap_matches_host(ndev):
    """Distributed x-slab RAP (one-brick-layer AP ppermute halo) equals
    the host product and is device-count invariant."""
    import jax
    from jax.sharding import Mesh
    from saamge_jax.setup.device_rap import sharded_structured_rap
    s, A, b, geo = _problem(8, (4, 2, 2))
    lv0 = s.ml.levels[0]
    tg0 = lv0.tg_data
    Ac_host = tg0.Ac.tocsr()
    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    Ac_sh = sharded_structured_rap(lv0.A.tocsr(), lv0.rels,
                                   tg0.tent_interp.tocsr(),
                                   tg0.interp_data.mis_numcoarsedof,
                                   geo, mesh)
    d = abs(Ac_sh - Ac_host).max()
    assert d <= 1e-5 * abs(Ac_host).max(), d
    assert Ac_sh.nnz == Ac_host.nnz


def test_scan_rap_matches_unrolled():
    """The compile-light lax.scan formulation (_rap_scan_jit,
    roll-and-mask dynamic shifts) equals the statically-unrolled
    reference (_rap_jit) on asymmetric geometries."""
    import jax
    import jax.numpy as jnp
    from saamge_jax.setup.device_rap import _rap_jit, _rap_scan_jit
    be, bricks, bs = (2, 3, 2), (3, 2, 2), 4
    nodes = tuple(B * b + 1 for B, b in zip(bricks, be))
    offsets3 = tuple((dx, dy, dz) for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    vals3 = jax.random.normal(ks[0], (27,) + nodes, jnp.float32)
    rst6 = jax.random.normal(
        ks[1], (bs, be[0] + 1, be[1] + 1, be[2] + 1) + bricks,
        jnp.float32)
    ref = np.asarray(_rap_jit(be, bricks, offsets3)(vals3, rst6))
    offs = jnp.asarray(np.asarray(offsets3, np.int32))
    got = np.asarray(_rap_scan_jit(be, bricks)(vals3, offs, rst6))
    assert np.abs(got - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())
