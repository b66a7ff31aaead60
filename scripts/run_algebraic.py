"""Driver mirroring the reference's `algebraic` test executable
(test/algebraic/algebraic.cpp): matrix-only spectral AMGe as a PCG
preconditioner on a matrix read from a hypre-format ASCII file.

ctest baseline: `algebraic --elems-per-agg 128 --theta 0.01` on
amg/data/anisotropic.mat.00000 converges in 12 iterations.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from saamge_jax.api import SAAMGeAlgPC
from saamge_jax.config import SolverOptions
from saamge_jax.setup.algebraic import read_hypre_matrix


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix",
                    default="/root/reference/amg/data/anisotropic.mat.00000")
    ap.add_argument("--elems-per-agg", type=int, default=128)
    ap.add_argument("--theta", type=float, default=0.01)
    ap.add_argument("--nu-pro", type=int, default=0)
    ap.add_argument("--nu-relax", type=int, default=3)
    ap.add_argument("--window", action="store_true",
                    help="Henson-Vassilevski window AMG submatrices")
    ap.add_argument("--no-eliminate-dof0", action="store_true")
    args = ap.parse_args()

    A = read_hypre_matrix(args.matrix)
    print(f"matrix: {A.shape[0]} x {A.shape[1]}, nnz {A.nnz}")

    opts = SolverOptions(theta=args.theta, nu_pro=args.nu_pro,
                         nu_relax=args.nu_relax,
                         first_elems_per_agg=args.elems_per_agg,
                         correct_nulspace=False)
    pc = SAAMGeAlgPC(A, opts, use_window=args.window,
                     eliminate_dof0=not args.no_eliminate_dof0)
    rng = np.random.default_rng(0)
    b = A @ rng.standard_normal(A.shape[0])
    res = pc.solve(b)
    print(f"iterations: {res.iterations} converged: {res.converged}")


if __name__ == "__main__":
    main()
