"""FOSLS Helmholtz block system + SAAMGeAlgPC parity
(reference ctests leastsquarealgebraic_{runs,fail}, CMakeLists.txt:236-250)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

from saamge_jax.config import SolverOptions
from saamge_jax.fem.helmholtz import ls_helmholtz_system


def test_system_dimensions():
    """Reference: 803 dofs eliminated (867 = 289 + 578 un-eliminated)."""
    sys_e = ls_helmholtz_system(k=-20.0, eliminate_bc=True)
    sys_f = ls_helmholtz_system(k=-20.0, eliminate_bc=False)
    assert sys_f.A.shape[0] == 867
    assert sys_e.A.shape[0] == 803


def test_system_spd_and_solvable():
    sys = ls_helmholtz_system(k=-20.0)
    A = sys.A
    assert abs(A - A.T).max() < 1e-10
    # FOSLS functional is SPD even for indefinite Helmholtz
    w = spla.eigsh(A, k=1, which="SA", return_eigenvectors=False)
    assert w[0] > 0
    x = spla.spsolve(A.tocsc(), sys.b)
    u, q = sys.recover(x)
    assert np.isfinite(u).all() and np.isfinite(q).all()


@pytest.mark.parametrize("k,max_iters", [(-20.0, 56), (-50.0, 115)])
def test_ls_helmholtz_algebraic_pcg(k, max_iters):
    """csv_data baselines: 56 iterations at k=-20, 115 at k=-50."""
    from saamge_jax.api import SAAMGeAlgPC
    sys = ls_helmholtz_system(k=k)
    opts = SolverOptions(theta=0.003, nu_relax=3, correct_nulspace=False,
                         first_elems_per_agg=256, rtol=0.0, maxiter=600)
    pc = SAAMGeAlgPC(sys.A, opts, eliminate_dof0=False)
    # reference uses AbsTol=1e-10 on (B r, r)
    from saamge_jax.solve.pcg import pcg
    res = pcg(sys.A, sys.b, pc.mult, rel_tol=0.0, abs_tol=1e-10,
              max_iter=600)
    assert res.converged
    assert res.iterations <= max_iters + int(0.15 * max_iters), \
        res.iterations
    x_ref = spla.spsolve(sys.A.tocsc(), sys.b)
    assert np.linalg.norm(res.x - x_ref) / np.linalg.norm(x_ref) < 1e-5


def test_ls_helmholtz_compiled_device_solve():
    """The algebraic preconditioner's two-grid data compiled to the device
    solve path (jitted PCG on the FOSLS monolithic system)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from saamge_jax.api import SAAMGeAlgPC
    from saamge_jax.solve.compiled import compile_two_level, pcg_solve

    sys_ = ls_helmholtz_system(k=-20.0)
    opts = SolverOptions(theta=0.003, correct_nulspace=False,
                         first_elems_per_agg=256, rtol=0.0, maxiter=600)
    pc = SAAMGeAlgPC(sys_.A, opts, eliminate_dof0=False)
    h = compile_two_level(sys_.A, pc.tg, dtype=jnp.float64)
    x, it, nom = pcg_solve(h, jnp.asarray(sys_.b), rel_tol=1e-12,
                           max_iter=600)
    x = np.asarray(x)
    rel = np.linalg.norm(sys_.b - sys_.A @ x) / np.linalg.norm(sys_.b)
    assert rel < 1e-6
    assert int(it) <= 60
