"""SPMD rank states -> sharded structured fine shards, no global fine
operator (parallel/spmd_structured.py).

Parity: the per-device z-lane DIA value arrays and haloed weighted-l1
smoother diagonals built from the rank-local assembled rows equal the
slices `shard_structured` takes from the controller-global hierarchy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from saamge_jax.api import SpectralAMGSolver, bdr_dof_flags
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.parallel.spmd_setup import spmd_coarsen
from saamge_jax.parallel.spmd_structured import spmd_fine_shards
from saamge_jax.parallel.structured_sharded import shard_structured
from saamge_jax.solve.structured import BrickGeometry, compile_structured
from saamge_jax.topology.part import partition_cartesian_3d


@pytest.mark.parametrize("ndev", [2, 4])
def test_spmd_fine_shards_match_global(ndev):
    n, nb = 16, 8
    mesh_h = hex_mesh(n)
    rng = np.random.default_rng(5)
    coefs = 10.0 ** rng.uniform(-1.0, 1.0, mesh_h.num_elements)
    ess = np.ones(mesh_h.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh_h, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh_h.elem_centers(), nb, nb, nb)

    # controller-global reference path
    s = SpectralAMGSolver(
        A, mesh_h, em,
        SolverOptions(num_levels=3, correct_nulspace=False),
        ess_attr_marker=ess, partitioning=part.copy())
    geo = BrickGeometry((nb,) * 3, (n // nb,) * 3)
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_format="brickblock")
    mesh = Mesh(np.array(jax.devices("cpu")[:ndev]), ("dp",))
    hs = shard_structured(h, mesh)

    # SPMD rank-decomposed path: same brick partitioning, rank blocks =
    # x-slabs (AE ids are x-major)
    e2d = mesh_h.elem_to_dof(1, 1)
    e2e = mesh_h.elem_to_elem()
    flags = bdr_dof_flags(mesh_h, ess)
    out = spmd_coarsen(e2d, e2e, em, flags, ndev,
                       partitioning=part.copy(), theta=0.003,
                       use_truncated=False)
    vals0, dinv0, offsets, dims = spmd_fine_shards(
        out.states, geo, ledger=out.ledger)

    assert tuple(offsets) == tuple(hs.st.offsets)
    for key, want in (("prow", hs.st.prow), ("sp1", hs.st.sp1),
                      ("real", hs.st.real),
                      ("local_pad", hs.st.local_pad),
                      ("hr_need", hs.st.hr_need), ("hr", hs.st.hr)):
        assert dims[key] == want, (key, dims[key], want)
    np.testing.assert_allclose(vals0, np.asarray(hs.vals0),
                               rtol=0, atol=0)
    np.testing.assert_allclose(dinv0, np.asarray(hs.dinv0),
                               rtol=1e-7, atol=1e-12)
    led = out.ledger.summary()
    assert "fine_shard_ghost_diag" in led
    # O(interface): the only cross-rank traffic of the shard build is
    # the ghost-diag exchange, bounded by a few node planes
    assert led["fine_shard_ghost_diag"]["max_rank_bytes"] \
        <= 8 * 4 * (n + 1) ** 2
