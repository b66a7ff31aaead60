"""Halo-exchange sharded SpMV/smoother vs single-device references."""

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.parallel.halo import HaloDIA, halo_smoother_fn, halo_spmv_fn
from saamge_jax.solve import smoothers


def _mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} devices")
    return JaxMesh(np.array(devs[:n]), axis_names=("dp",))


@pytest.fixture(scope="module")
def poisson():
    mesh = hex_mesh(10)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    return A, b


def _pad_sharded(v, n_pad, mesh):
    vp = np.zeros(n_pad)
    vp[:len(v)] = v
    return jax.device_put(vp, NamedSharding(mesh, P("dp")))


@pytest.mark.parametrize("ndev", [2, 8])
def test_halo_spmv_matches_scipy(poisson, ndev):
    A, b = poisson
    mesh = _mesh(ndev)
    H = HaloDIA.build(A, mesh, dtype=jnp.float64)
    f = halo_spmv_fn(H)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    y = np.asarray(f(_pad_sharded(x, H.n_pad, mesh)))[:A.shape[0]]
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)


def test_halo_smoother_matches_host(poisson):
    A, b = poisson
    mesh = _mesh(8)
    H = HaloDIA.build(A, mesh, dtype=jnp.float64)
    pd = smoothers.init_poly_data(A, 3, "sas")
    f = halo_smoother_fn(H, pd.dinv, pd.roots, dtype=jnp.float64)
    x0 = np.zeros(A.shape[0])
    y = np.asarray(f(_pad_sharded(b, H.n_pad, mesh),
                     _pad_sharded(x0, H.n_pad, mesh)))[:A.shape[0]]
    ref = smoothers.compute_poly(A, b, x0.copy(), pd.roots, pd.dinv)
    np.testing.assert_allclose(y, ref, rtol=1e-11, atol=1e-12)
