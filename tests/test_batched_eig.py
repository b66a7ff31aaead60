"""Batched device eigensolves (ops.batched_eig) vs the host Eigensolver."""

import numpy as np
import pytest

from saamge_jax.ops.batched_eig import (batched_spectral_cut,
                                        batched_weighted_l1)
from saamge_jax.setup.spectral import Eigensolver, weighted_l1_diag


def _rand_spd_laplacian(n, rng):
    """1D Laplacian-like SPD matrix with random weights."""
    w = rng.uniform(0.5, 2.0, n - 1)
    A = np.zeros((n, n))
    for i in range(n - 1):
        A[i, i] += w[i]
        A[i + 1, i + 1] += w[i]
        A[i, i + 1] -= w[i]
        A[i + 1, i] -= w[i]
    A += np.eye(n) * 1e-8
    return A


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(7)
    return [_rand_spd_laplacian(n, rng)
            for n in [5, 17, 17, 33, 64, 40, 8, 100]]


def test_batched_weighted_l1_matches_host(mats):
    n = 17
    stack = np.stack([m for m in mats if m.shape[0] == n])
    got = batched_weighted_l1(stack)
    for k, m in enumerate([m for m in mats if m.shape[0] == n]):
        np.testing.assert_allclose(got[k], weighted_l1_diag(m), rtol=1e-12)


def test_batched_cut_counts_match_host(mats):
    theta = 0.05
    cut, skipped, bdiags = batched_spectral_cut(mats, theta)
    eig = Eigensolver(use_truncated=False)
    for i, A in enumerate(mats):
        ev_h, skip_h, B_h = eig.solve(A, theta)
        assert cut[i].shape == ev_h.shape, f"AE {i}"
        np.testing.assert_allclose(bdiags[i], B_h, rtol=1e-10)
        np.testing.assert_allclose(skipped[i], skip_h, rtol=1e-6, atol=1e-9)
        # same invariant subspace: B-orthogonal projector difference small
        Pb_h = ev_h @ ev_h.T * B_h[None, :]
        Pb_d = cut[i] @ cut[i].T * bdiags[i][None, :]
        np.testing.assert_allclose(Pb_d, Pb_h, atol=1e-6)


def test_batched_cut_b_orthonormal(mats):
    cut, _, bdiags = batched_spectral_cut(mats, 0.05)
    for X, B in zip(cut, bdiags):
        G = X.T @ (B[:, None] * X)
        np.testing.assert_allclose(G, np.eye(X.shape[1]), atol=1e-6)


def test_truncated_mode_caps(mats):
    big = [m for m in mats if m.shape[0] > 64]
    # theta high enough that everything under the cap qualifies
    cut, _, _ = batched_spectral_cut(big, 0.9, use_truncated=True,
                                     max_vectors=4)
    for X in cut:
        assert X.shape[1] <= 4


def test_end_to_end_same_iterations():
    """Full solver with device_setup=True converges like the host path."""
    from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
    from saamge_jax.config import SolverOptions
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import quad_mesh

    mesh = quad_mesh(20)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, ess_attr_marker=ess)

    iters = {}
    for device_setup in (False, True):
        opts = SolverOptions(num_levels=2, correct_nulspace=False,
                             first_elems_per_agg=32,
                             device_setup=device_setup)
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
        res = s.solve(b)
        assert res.converged
        iters[device_setup] = res.iterations
    assert abs(iters[True] - iters[False]) <= 1, iters


def test_batched_cut_sharded_over_mesh(mats):
    """Distributed setup: AE batches row-sharded over the device mesh give
    the same spectral cuts."""
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < 4:
        devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("need 4 devices")
    mesh = Mesh(np.array(devs[:4]), axis_names=("dp",))
    theta = 0.05
    cut0, skip0, b0 = batched_spectral_cut(mats, theta)
    cut1, skip1, b1 = batched_spectral_cut(mats, theta, mesh=mesh)
    for i in range(len(mats)):
        assert cut0[i].shape == cut1[i].shape
        np.testing.assert_allclose(b0[i], b1[i], rtol=1e-12)
        np.testing.assert_allclose(abs(cut0[i]), abs(cut1[i]), atol=1e-5)


def test_filtered_eig_matches_eigh():
    """The Chebyshev-filtered subspace eigensolver returns the smallest
    eigenpairs of each batched matrix (vs the exact spectrum), for the
    Laplacian-like spectra of scaled AE operators (a low cluster under
    a bulk reaching ~2)."""
    import numpy as np
    import jax.numpy as jnp
    from saamge_jax.ops.filtered_eig import batched_smallest_eigs
    rng = np.random.default_rng(0)
    B, n, m = 4, 48, 8
    lam = 2.0 * (np.arange(n) / n) ** 2
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    M = np.einsum("bij,j,bkj->bik", Q, lam, Q)
    w, X, res = batched_smallest_eigs(jnp.asarray(M, jnp.float32), m)
    np.testing.assert_allclose(np.asarray(w)[:, :m // 2],
                               np.broadcast_to(lam[:m // 2], (B, m // 2)),
                               atol=5e-4)   # f32 + leakage, ~2e-4 of sigma
    assert np.asarray(res)[:, :m // 2].max() < 1e-3
