import numpy as np
import pytest

from saamge_jax.setup.spectral import Eigensolver, weighted_l1_diag
from saamge_jax.solve import smoothers


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def test_weighted_l1_diag_formula():
    A = np.array([[4.0, -1.0, 0.0],
                  [-1.0, 2.0, -0.5],
                  [0.0, -0.5, 1.0]])
    d = weighted_l1_diag(A)
    expect = np.zeros(3)
    diag = np.diag(A)
    for i in range(3):
        expect[i] = sum(abs(A[i, j]) * np.sqrt(diag[i] / diag[j])
                        for j in range(3))
    np.testing.assert_allclose(d, expect)


def test_weighted_l1_majorizes_A():
    # the weighted l1 smoother satisfies x^T A x <= x^T D x (lmax <= 1),
    # the property the theta*lmax cut relies on (spectral.cpp:134)
    A = _spd(20, 1)
    d = weighted_l1_diag(A)
    evals = np.linalg.eigvalsh(np.diag(1 / np.sqrt(d)) @ A
                               @ np.diag(1 / np.sqrt(d)))
    assert evals.max() <= 1.0 + 1e-12


def test_eigensolver_cut_semantics():
    A = _spd(12, 2)
    eig = Eigensolver(use_truncated=False)
    X, skipped, B = eig.solve(A, theta=0.5)
    # generalized eigenpairs: A x = lambda B x with lambda <= 0.5 kept
    lams = np.diag(X.T @ A @ X) / np.diag(X.T @ (B[:, None] * X))
    assert (lams <= 0.5 + 1e-10).all()
    assert skipped > 0.5 - 1e-12
    # at least one vector even for tiny theta
    X2, _, _ = eig.solve(A, theta=1e-30)
    assert X2.shape[1] == 1


def test_eigensolver_b_orthonormal():
    A = _spd(10, 3)
    eig = Eigensolver(use_truncated=False)
    X, _, B = eig.solve(A, theta=1.0)  # take everything
    G = X.T @ (B[:, None] * X)
    np.testing.assert_allclose(G, np.eye(X.shape[1]), atol=1e-10)


def test_truncated_mode_caps_vectors():
    A = _spd(100, 4)
    eig = Eigensolver(threshold=64, use_truncated=True, max_vectors=10)
    X, skipped, B = eig.solve(A, theta=1.0)
    assert X.shape[1] <= 10


def test_sas_roots():
    # smpr_sas_poly_roots (smpr.cpp:282): degree 3nu+1
    nu = 3
    r = smoothers.sas_poly_roots(nu)
    assert len(r) == 3 * nu + 1
    denom = 2 * nu + 1
    np.testing.assert_allclose(r[0], 1.0)  # cos^2(0)
    np.testing.assert_allclose(r[1], np.cos(np.pi / denom) ** 2)
    np.testing.assert_allclose(r[-1], np.sin(nu * np.pi / denom) ** 2)


def test_smoother_contracts_in_energy():
    import scipy.sparse as sp
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import quad_mesh
    mesh = quad_mesh(10)
    A, b, em, e2d, ess = assemble.build_discrete_problem(mesh, coef=1.0)
    pd = smoothers.init_poly_data(A, 3, "sas")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    e0 = x @ (A @ x)
    x = smoothers.sym_poly(A, np.zeros_like(x), x, pd)
    e1 = x @ (A @ x)
    assert e1 < e0


def test_gauss_seidel_l1_smooths():
    import scipy.sparse as sp
    from saamge_jax.solve.smoothers import gauss_seidel_l1
    n = 40
    A = sp.diags([-np.ones(n - 1), 2.01 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n)
    b = A @ x_true
    x = np.zeros(n)
    e0 = np.sqrt((x - x_true) @ (A @ (x - x_true)))
    for _ in range(5):
        x = gauss_seidel_l1(A, b, x)
    e1 = np.sqrt((x - x_true) @ (A @ (x - x_true)))
    assert e1 < 0.5 * e0


def test_schur_eigensolve_minimal_energy():
    from saamge_jax.setup.spectral import schur_eigensolve
    rng = np.random.default_rng(5)
    n = 30
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    agg = np.arange(0, 12)
    V, skipped = schur_eigensolve(A, agg, theta=0.5)
    assert V.shape[0] == n and V.shape[1] >= 1
    # harmonic extension: rest-block residual of A V must vanish
    rest = np.arange(12, n)
    res = A[np.ix_(rest, np.arange(n))] @ V
    assert np.abs(res).max() < 1e-8
    # extension is minimal-energy: energy <= any other extension (spot check)
    V2 = V.copy()
    V2[rest] += 0.1 * rng.standard_normal(V2[rest].shape)
    for j in range(V.shape[1]):
        assert V[:, j] @ (A @ V[:, j]) <= V2[:, j] @ (A @ V2[:, j]) + 1e-12


def test_svd_dedup_drops_injected_duplicate_vector():
    """The reference's testmesh fault injection (interp.cpp:510-524):
    appending a linearly-dependent extra eigenvector on one AE must not
    change the coarse space — the per-MIS SVD (sigma > eps*sigma_max
    cut, contrib.cpp SVDInsert) dedups it.  Coarse dimension and the
    tent-P column SPACE must be identical."""
    import scipy.sparse as sp
    from saamge_jax.api import SpectralAMGSolver
    from saamge_jax.config import SolverOptions
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import quad_mesh
    from saamge_jax.setup import contrib

    mesh = quad_mesh(12)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    s = SpectralAMGSolver(A, mesh, em,
                          SolverOptions(num_levels=2,
                                        correct_nulspace=False,
                                        elems_per_agg=16,
                                        device_setup=False),
                          ess_attr_marker=ess)
    lv0 = s.ml.levels[0]
    tg0 = lv0.tg_data
    cut = [np.asarray(c) for c in tg0.interp_data.cut_evects_arr]

    t_ref = contrib.build_tentative(lv0.rels, cut)
    # inject a duplicate (scaled copy of the first eigenvector) on AE 0
    cut_dup = [c.copy() for c in cut]
    cut_dup[0] = np.hstack([cut_dup[0], 0.5 * cut_dup[0][:, :1]])
    t_dup = contrib.build_tentative(lv0.rels, cut_dup)

    assert np.array_equal(t_ref.mis_numcoarsedof, t_dup.mis_numcoarsedof)
    P1 = t_ref.P.todense()
    P2 = t_dup.P.todense()
    assert P1.shape == P2.shape
    # same column space: projections onto each other's range agree
    Q1, _ = np.linalg.qr(P1)
    assert np.linalg.norm(P2 - Q1 @ (Q1.T @ P2)) <= 1e-8


def _clustered_contrast_chain(n=600, ninc=6, strong=1e6):
    """1D diffusion chain with ``ninc`` strong inclusions separated by
    weak links: the weighted-l1-scaled operator has ``ninc`` clustered
    near-zero eigenvalues — the high-contrast regime where
    unpreconditioned LOBPCG at tol 1e-4 stalls (the reference handles
    it with shift-invert ARPACK, arpacks.cpp:220-240)."""
    import scipy.sparse as sp
    coef = np.ones(n + 1)
    for i in range(ninc):
        coef[i * (n // ninc) + 5:i * (n // ninc) + (n // ninc) - 5] = strong
    rows, cols, vals = [], [], []
    for e in range(n):
        c = coef[e]
        for (i, j, v) in ((e, e, c), (e + 1, e + 1, c),
                          (e, e + 1, -c), (e + 1, e, -c)):
            rows.append(i), cols.append(j), vals.append(v)
    A = sp.coo_matrix((vals, (rows, cols)),
                      shape=(n + 1, n + 1)).tocsr()
    return A + 1e-8 * sp.eye(n + 1)


@pytest.mark.filterwarnings("error::UserWarning")
def test_truncated_shift_invert_clustered_spectrum():
    """On a clustered low spectrum the plain
    truncated path misses the theta cut (eigenvalue errors ~1e-7 around
    a theta=1e-7 cut) while the shift-invert-hardened path reproduces
    the direct solver's coarse dimension and eigenvalues.

    The solver converges (or accepts its best
    iterate) within its own budget — no LOBPCG warnings escape
    (filterwarnings marker turns any into a failure)."""
    from saamge_jax.setup.spectral import Eigensolver, weighted_l1_diag
    A = _clustered_contrast_chain()
    theta = 1e-7
    B = weighted_l1_diag(A)
    dhalf = 1.0 / np.sqrt(B)
    M = (dhalf[:, None] * A.toarray()) * dhalf[None, :]
    evals_true = np.linalg.eigvalsh(0.5 * (M + M.T))
    m_true = max(int(np.searchsorted(evals_true, theta, side="right")), 1)
    assert m_true == 6            # the six inclusion modes

    # plain truncated path (shift_invert='never'): the documented
    # failure — wrong theta-cut count on this spectrum
    eig_plain = Eigensolver(shift_invert="never")
    Xp, _, _ = eig_plain.solve(A, theta)
    assert Xp.shape[1] < m_true

    # hardened path ('auto' triggers the residual guard here)
    eig = Eigensolver(shift_invert="auto")
    X, skipped, _ = eig.solve(A, theta)
    assert X.shape[1] == m_true, (X.shape, m_true)
    # eigenvalue accuracy at the cut: Rayleigh quotients of returned
    # vectors match the true lowest eigenvalues far below theta
    Bx = B[:, None] * X
    rq = np.einsum("im,im->m", X, A @ X) / np.einsum("im,im->m", X, Bx)
    assert np.abs(np.sort(rq) - evals_true[:m_true]).max() < 1e-9
    assert skipped >= theta
