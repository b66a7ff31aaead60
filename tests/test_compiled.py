"""Device (jitted JAX) solve path vs the host reference implementation."""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh, quad_mesh
from saamge_jax.ops.sparse import (DeviceDIA, DeviceELL, device_matrix,
                                   dia_spmv, ell_spmv)
from saamge_jax.solve import compiled


@pytest.fixture(scope="module")
def two_level():
    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, e2d, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=3, correct_nulspace=False,
                         first_elems_per_agg=16, elems_per_agg=4)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    return mesh, A, b, s


def test_ell_spmv_matches_scipy():
    import scipy.sparse as sp
    A = sp.random(50, 70, density=0.15, random_state=0).tocsr()
    x = np.random.default_rng(1).standard_normal(70)
    ell = DeviceELL.from_csr(A, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(ell_spmv(ell, jnp.asarray(x))),
                               A @ x, rtol=1e-12)


def test_dia_spmv_matches_scipy():
    import scipy.sparse as sp
    mesh = hex_mesh(5)
    A, b, em, e2d, _ = assemble.build_discrete_problem(mesh, coef=1.0)
    dia = DeviceDIA.try_from_csr(A, dtype=jnp.float64)
    assert dia is not None, "structured hex Poisson should be DIA-able"
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    np.testing.assert_allclose(np.asarray(dia_spmv(dia, jnp.asarray(x))),
                               A @ x, rtol=1e-12, atol=1e-12)


def test_compiled_vcycle_matches_host(two_level):
    mesh, A, b, s = two_level
    h = compiled.compile_hierarchy(s.ml, dtype=jnp.float64)
    r = np.random.default_rng(3).standard_normal(A.shape[0])
    # host V-cycle
    z_host = np.zeros_like(r)
    from saamge_jax.solve.vcycle import tg_cycle
    tg_cycle(A, s.ml.finest.tg_data, r, z_host)
    # device V-cycle
    z_dev = np.asarray(compiled.vcycle_apply(h, jnp.asarray(r)))
    np.testing.assert_allclose(z_dev, z_host, rtol=1e-9, atol=1e-9)


def test_compiled_pcg_matches_host_iterations(two_level):
    mesh, A, b, s = two_level
    res_host = s.solve(b)
    h = compiled.compile_hierarchy(s.ml, dtype=jnp.float64)
    x, it, nom = compiled.pcg_solve(h, jnp.asarray(b), max_iter=200)
    assert int(it) == res_host.iterations
    np.testing.assert_allclose(np.asarray(x), res_host.x, rtol=1e-6,
                               atol=1e-8)


def test_compiled_pcg_f32_converges(two_level):
    mesh, A, b, s = two_level
    h = compiled.compile_hierarchy(s.ml, dtype=jnp.float32)
    x, it, nom = compiled.pcg_solve(h, jnp.asarray(b, dtype=jnp.float32),
                                    rel_tol=1e-5, max_iter=200)
    x = np.asarray(x, dtype=np.float64)
    rel_res = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    assert rel_res < 3e-4  # f32 accuracy floor
    assert int(it) < 50


def test_compiled_vcycle_smoothed_P_matches_host():
    """Smoothed prolongator (nu_pro > 0, the SA default in the
    reference) through the DEVICE hierarchy: the jitted V-cycle with
    ELL-format smoothed P/R must reproduce the host cycle exactly —
    the device story for interp smoothing (tg_smooth_interp,
    tg.cpp:458)."""
    from saamge_jax.solve.vcycle import tg_cycle
    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=16, nu_pro=2,
                         first_nu_pro=2)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    assert s.ml.finest.tg_data.smooth_interp
    h = compiled.compile_hierarchy(s.ml, dtype=jnp.float64)
    rng = np.random.default_rng(4)
    r = rng.standard_normal(A.shape[0])
    z_host = np.zeros_like(r)
    tg_cycle(A, s.ml.finest.tg_data, r, z_host)
    z_dev = np.asarray(compiled.vcycle_apply(h, jnp.asarray(r)))
    np.testing.assert_allclose(z_dev, z_host, rtol=1e-9, atol=1e-9)
