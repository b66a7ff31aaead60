"""Driver mirroring `basicupscale` (test/basicupscale/basicupscale.cpp):
build a two-level spectral coarse space for a checkerboard diffusion
problem, solve the COARSE problem, prolongate to the fine grid, and report
the upscaling error vs the true fine solution; then run the usual PCG.
"""

import argparse
import sys

import numpy as np
import scipy.sparse.linalg as spla

sys.path.insert(0, ".")

from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh, quad_mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--elems-per-agg", type=int, default=128)
    ap.add_argument("--nu-pro", type=int, default=0)
    args = ap.parse_args()

    mesh = quad_mesh(args.n) if args.dim == 2 else hex_mesh(args.n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(theta=args.theta, nu_pro=args.nu_pro,
                         num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=args.elems_per_agg)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    tg = s.ml.finest.tg_data

    # upscaled solution: restrict rhs, solve coarse, prolongate
    bc = tg.restr @ b
    xc = spla.spsolve(tg.Ac.tocsc(), bc)
    x_up = tg.interp @ xc
    x_true = spla.spsolve(A.tocsc(), b)
    num = np.sqrt((x_up - x_true) @ (A @ (x_up - x_true)))
    den = np.sqrt(x_true @ (A @ x_true))
    print(f"coarse dim: {tg.Ac.shape[0]} / fine dim: {A.shape[0]}")
    print(f"relative upscaling energy error: {num / den:.6f}")

    res = s.solve(b)
    print(f"iterations: {res.iterations} converged: {res.converged}")


if __name__ == "__main__":
    main()
