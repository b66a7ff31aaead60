"""Driver mirroring `encapsulate` (test/encapsulate/encapsulate.cpp +
elasticity.sh): the one-object SAAMGePC preconditioner on 2D elasticity."""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from saamge_jax.api import SAAMGePC
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import quad_mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--num-levels", type=int, default=2)
    ap.add_argument("--elems-per-agg", type=int, default=64)
    args = ap.parse_args()

    mesh = quad_mesh(args.n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, elasticity=True)
    # body force (the reference's elasticity path tests with zero rhs;
    # here apply a unit load so the solve is non-trivial)
    b = assemble.domain_lf(mesh, 1.0, 1, mesh.dim)
    b[ess_dofs] = 0.0
    pc = SAAMGePC(
        A, mesh, em,
        SolverOptions(theta=args.theta, num_levels=args.num_levels,
                      correct_nulspace=False,
                      first_elems_per_agg=args.elems_per_agg),
        vdim=mesh.dim, ess_attr_marker=ess)
    res = pc.solve(b)
    print(f"iterations: {res.iterations} converged: {res.converged}")


if __name__ == "__main__":
    main()
