"""Driver mirroring the reference's `mltest` on the 12-element testmesh.

Usage: python scripts/run_mltest.py [--num-levels N] [--order K] ...
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from saamge_jax.api import (SpectralAMGSolver, checkerboard_coef)
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import read_mesh


TESTMESH_PARTITION = np.array([0, 0, 1, 1, 0, 0, 2, 2, 3, 3, 3, 2])
# mltest.cpp:221-231: AE0={0,1,4,5}, AE1={2,3}, AE2={6,7,11}, AE3={8,9,10}
TESTMESH_COARSE_PARTITION = np.array([0, 0, 1, 1])
# aggregates.cpp:1777-1782


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="/root/reference/amg/test/mltest.mesh")
    ap.add_argument("--num-levels", type=int, default=2)
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--nu-relax", type=int, default=3)
    ap.add_argument("--nu-pro", type=int, default=0)
    ap.add_argument("--elasticity", action="store_true")
    ap.add_argument("--constant-coefficient", action="store_true")
    ap.add_argument("--zero-rhs", action="store_true")
    ap.add_argument("--correct-nulspace", action="store_true")
    args = ap.parse_args()

    mesh = read_mesh(args.mesh)
    mltest = (mesh.num_vertices == 20 and mesh.num_elements == 12)
    ess = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
    if mltest:
        ess[3] = 1
    else:
        ess[:] = 1

    coef = 1.0 if args.constant_coefficient else checkerboard_coef
    A, b, elem_mats, e2d, ess_dofs = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess, order=args.order,
        elasticity=args.elasticity)
    print(f"ND: {A.shape[0]}, NE: {mesh.num_elements}")

    opts = SolverOptions(
        theta=args.theta, nu_relax=args.nu_relax, nu_pro=args.nu_pro,
        num_levels=args.num_levels, correct_nulspace=args.correct_nulspace,
        zero_rhs=args.zero_rhs)
    part = TESTMESH_PARTITION if mltest else None
    coarse_override = None
    if mltest and args.num_levels > 2:
        coarse_override = lambda i: TESTMESH_COARSE_PARTITION \
            if i == 1 else None

    vdim = mesh.dim if args.elasticity else 1
    if vdim > 1 and part is not None:
        pass  # same element partition applies
    solver = SpectralAMGSolver(A, mesh, elem_mats, opts, order=args.order,
                               vdim=vdim, ess_attr_marker=ess,
                               partitioning=part,
                               coarse_part_override=coarse_override)
    if args.zero_rhs:
        rng = np.random.default_rng(0)
        x0 = rng.random(A.shape[0])
        x0[list(ess_dofs)] = 0.0
        b = np.zeros_like(b)
        res = solver.solve(b, x0=x0)
    else:
        res = solver.solve(b)
    print("iterations:", res.iterations, "converged:", res.converged)
    return res


if __name__ == "__main__":
    main()
