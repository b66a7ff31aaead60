"""Uniform-brick device setup pipeline (setup/device_setup.py) vs the
host per-AE path: same AE stiffness, same spectral cuts, same hierarchy.
"""

import numpy as np
import pytest

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.topology.part import partition_cartesian_3d
from saamge_jax.setup.device_setup import analyze_uniform, \
    uniform_spectral_cut
from saamge_jax.setup.elmat import GeometricProvider
from saamge_jax.api import geometric_partitioning, bdr_dof_flags


def _mk(n=8, nb=2, coef=None):
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    if coef is None:
        rng = np.random.default_rng(0)
        cvals = 10.0 ** rng.uniform(-2, 2, mesh.num_elements)
        centers = mesh.elem_centers()

        def coef_fn(x):
            # piecewise-constant random high-contrast coefficient
            i = np.argmin(np.abs(centers - x).sum(axis=1))
            return cvals[i]
        coef = coef_fn
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    flags = bdr_dof_flags(mesh, ess)
    rels = geometric_partitioning(A, mesh, flags, nb ** 3,
                                  partitioning=part)
    return mesh, A, b, em, rels


def test_analyze_uniform_detects_bricks():
    mesh, A, b, em, rels = _mk()
    plan = analyze_uniform(rels, em)
    assert plan is not None
    assert plan.n == rels.AE_to_dof.row_sizes()[0]
    # non-uniform partition -> rejected
    from saamge_jax.topology.part import partition_kway
    from saamge_jax.utils.tables import Table
    part2 = partition_kway(
        Table.from_csr_like(None, mesh.elem_to_elem().indptr,
                            mesh.elem_to_elem().indices)
        if False else mesh.elem_to_elem(), None, 8)
    rels2 = geometric_partitioning(
        A, mesh, bdr_dof_flags(mesh, np.ones(mesh.max_bdr_attr(),
                                             dtype=np.int64)),
        8, partitioning=np.asarray(part2))
    # irregular partitions typically have unequal AE sizes
    if analyze_uniform(rels2, em) is not None:
        sizes = rels2.AE_to_dof.row_sizes()
        assert sizes.min() == sizes.max()


def test_uniform_cut_matches_host_eigensolver():
    mesh, A, b, em, rels = _mk()
    prov = GeometricProvider(rels, A, em)
    theta = 0.003
    out = uniform_spectral_cut(prov, theta)
    assert out is not None
    cut, skipped, bdiags, aes = out

    from saamge_jax.setup.spectral import Eigensolver
    eig = Eigensolver()
    for p in range(rels.nparts):
        A_T = prov.build_AE_stiff(p)
        # sparse AE export matches the host AE stiffness
        assert np.allclose(np.asarray(aes[p].todense()), A_T,
                           rtol=1e-5, atol=1e-6 * np.abs(A_T).max())
        ev_ref, skip_ref, B_ref = eig.solve(A_T, theta)
        assert np.allclose(bdiags[p], B_ref, rtol=1e-4)
        assert cut[p].shape[1] == ev_ref.shape[1], f"AE {p} dim"
        assert abs(skipped[p] - skip_ref) <= 1e-4 * max(1.0, skip_ref)
        # same subspace: project device evects onto host basis (B inner
        # product) and check norms are preserved
        Bd = B_ref
        G = ev_ref.T @ (Bd[:, None] * ev_ref)
        coeffs = np.linalg.solve(G, ev_ref.T @ (Bd[:, None] * cut[p]))
        resid = cut[p] - ev_ref @ coeffs
        nrm = np.sqrt(np.einsum("ij,ij->j", resid, Bd[:, None] * resid))
        ref_n = np.sqrt(np.einsum("ij,ij->j", cut[p],
                                  Bd[:, None] * cut[p]))
        assert np.all(nrm <= 5e-3 * np.maximum(ref_n, 1e-12))


def test_full_solver_device_setup_parity():
    """End-to-end: device_setup=True must give the same coarse dims and
    iteration count as the host setup."""
    mesh = hex_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
    its, dims = [], []
    for dev in (False, True):
        opts = SolverOptions(num_levels=2, correct_nulspace=False,
                             device_setup=dev)
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                             partitioning=part.copy())
        res = s.solve(b)
        its.append(res.iterations)
        dims.append(s.ml.levels[0].tg_data.Ac.shape[0])
    assert dims[0] == dims[1]
    assert abs(its[0] - its[1]) <= 1


def test_device_setup_covers_anisotropic_tensor():
    """The flagship BASELINE config ('large 3D anisotropic') must take
    the device pipeline: analyze_uniform factors the tensor-coefficient
    element matrices through a small SVD basis (r <= d(d+1)/2 + 1)
    instead of requiring scalar multiples, and the resulting hierarchy
    matches the host setup (AnisotropicDiffusionIntegrator.cpp:131-149)."""
    from saamge_jax.fem.coefficients import anisotropic_tensor
    mesh = hex_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coef = anisotropic_tensor(lambda x: np.array(
        [1.0, 0.5 * np.sin(4 * x[0]), 0.25]), eps=0.01)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess, matrix_coef=True)
    part = partition_cartesian_3d(mesh.elem_centers(), 2, 2, 2)
    flags = bdr_dof_flags(mesh, ess)
    rels = geometric_partitioning(A, mesh, flags, 8, partitioning=part)
    plan = analyze_uniform(rels, em)
    assert plan is not None, "anisotropic elmats rejected by the plan"
    assert 1 < plan.r <= 8, plan.r

    its, dims = [], []
    for dev in (False, True):
        opts = SolverOptions(num_levels=2, correct_nulspace=False,
                             device_setup=dev)
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                              partitioning=part.copy())
        res = s.solve(b)
        its.append(res.iterations)
        dims.append(s.ml.levels[0].tg_data.Ac.shape[0])
    assert dims[0] == dims[1]
    assert abs(its[0] - its[1]) <= 1


def test_filtered_eig_matches_eigh():
    """Chebyshev-filtered subspace solver vs numpy eigh on a random SPD
    stack (the ARPACK/LAPACK-replacement kernel, ops/filtered_eig.py)."""
    import jax.numpy as jnp
    from saamge_jax.ops.filtered_eig import batched_smallest_eigs
    rng = np.random.default_rng(3)
    B, n, m = 6, 256, 24
    mats = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        # spectrum with a low cluster (spectral-AMGe-like)
        w = np.concatenate([rng.uniform(1e-4, 0.05, 12),
                            rng.uniform(0.3, 2.0, n - 12)])
        mats.append((Q * w) @ Q.T)
    M = jnp.asarray(np.stack(mats), jnp.float32)
    w_got, X, res = batched_smallest_eigs(M, m)
    X = np.asarray(X, np.float64)
    for b in range(B):
        w_ref = np.linalg.eigvalsh(mats[b])[:m]
        # eigenvalues of the low cluster to ~f32 accuracy
        assert np.allclose(w_got[b][:12], w_ref[:12],
                           rtol=5e-3, atol=5e-5), b
        # the self-reported residual guard agrees: low cluster converged
        assert res[b][:12].max() < 0.05, (b, res[b][:12].max())
        # the low-cluster eigenvectors are captured: residual check
        for j in range(12):
            x = X[b][:, j]
            lam = x @ (mats[b] @ x) / (x @ x)
            r = mats[b] @ x - lam * x
            assert np.linalg.norm(r) <= 5e-3 * np.linalg.norm(
                mats[b] @ x) + 1e-4, (b, j)


def test_filtered_eig_residual_guard_flags_hard_spectrum():
    """A weak filter on a spectrum clustered at the cut must REPORT its
    failure through the residual channel (so uniform_spectral_cut /
    batched_eig route those AEs to the exact solver) — the theta-cut
    sensitivity guard (reference spectral.hpp:32-60)."""
    import jax.numpy as jnp
    from saamge_jax.ops.filtered_eig import batched_smallest_eigs
    rng = np.random.default_rng(11)
    n, m = 256, 24
    # Gershgorin-tight matrices (like the weighted-l1-scaled AE
    # operators: sigma ~ lambda_max): diagonal spectrum + local coupling
    P = rng.standard_normal((n, n)) * 0.002
    P = (P + P.T) / 2
    # near-continuum spectrum: no gap anywhere near the subspace edge
    A = np.diag(np.linspace(1.0, 2.0, n)) + P
    M = jnp.asarray(A[None], jnp.float32)
    # degree-1 single-round filter on a gapless spectrum cannot converge
    w_got, X, res = batched_smallest_eigs(M, m, degree=1, rounds=1)
    assert res[0].max() > 0.05, res[0].max()
    # and the production settings on an easy spectrum stay well below
    w2 = np.concatenate([np.full(8, 1e-3), np.linspace(0.9, 1.1, n - 8)])
    A2 = np.diag(w2) + P
    _, _, res2 = batched_smallest_eigs(jnp.asarray(A2[None], jnp.float32),
                                       m)
    assert res2[0][:8].max() < 0.05, res2[0][:8].max()
