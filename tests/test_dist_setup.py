"""Distributed setup (parallel/dist_setup.py): device-count invariance.

The reference's pmltest asserts identical convergence under mpirun -n 1
and -n 2; the JAX analog shards the setup-phase eigensolve batches and
the per-MIS owner-computes SVD over a device mesh, and must produce the
SAME coarse dimensions and PCG iteration counts for any device count."""

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


def _run(setup_mesh, device_setup):
    mesh = hex_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(0)
    coefs = 10.0 ** rng.uniform(-1, 1, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         device_setup=device_setup)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, setup_mesh=setup_mesh)
    res = s.solve(b)
    return s.ml.levels[0].tg_data.Ac.shape[0], res.iterations


@pytest.mark.parametrize("device_setup", [False, True])
def test_device_count_invariance(device_setup):
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should provide 8 virtual devices"
    m1 = Mesh(np.array(devs[:1]), axis_names=("dp",))
    m8 = Mesh(np.array(devs[:8]), axis_names=("dp",))
    dim1, it1 = _run(m1, device_setup)
    dim8, it8 = _run(m8, device_setup)
    dim0, it0 = _run(None, device_setup)
    assert dim1 == dim8 == dim0
    assert it1 == it8 == it0
