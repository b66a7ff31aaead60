"""Driver mirroring `partialsmooth` (test/partialsmooth/partialsmooth.cpp):
a DoubleCycle whose inner corrected-nullspace level SMOOTHS the minimal
(scaling) interpolator while the spectral space stays unsmoothed."""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import quad_mesh
from saamge_jax.solve.coarse import CorrectNullspace
from saamge_jax.solve.pcg import pcg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--num-levels", type=int, default=3)
    ap.add_argument("--nu-relax", type=int, default=3)
    args = ap.parse_args()

    mesh = quad_mesh(args.n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(theta=args.theta, num_levels=args.num_levels,
                         nu_relax=args.nu_relax, correct_nulspace=True,
                         double_cycle=True, first_elems_per_agg=64,
                         elems_per_agg=16)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    # partial smoothing: re-make the inner corrected-nullspace solver with
    # a SMOOTHED minimal interpolator (smooth_phat), spectral P unsmoothed
    tg = s.ml.finest.tg_data
    s.precond.inner = CorrectNullspace(tg.Ac, tg.scaling_P,
                                       smoother_steps=2, smooth_phat=True,
                                       v_cycle=True)
    res = pcg(A, b, s.mult, rel_tol=1e-6, max_iter=200)
    print(f"iterations: {res.iterations} converged: {res.converged}")


if __name__ == "__main__":
    main()
