"""Driver mirroring `leastsquaretest` (mesh-based mixed least-squares
second-order PDE + geometric SAAMGe block preconditioner).

Reference: amg/test/leastsquaretest/leastsquaretest.cpp:150-340 — build the
FOSLS Helmholtz block system [M B^T; B G] on a mesh (LSHelmholtzProblem),
precondition with a block-diagonal pair of geometric SAAMGePC hierarchies
(one on the scalar block with all-boundary essential BCs, one on the vector
block with none), solve with CG (abs tol 1e-10, maxiter 1000), and print

  n_iterations: <N>
  final_norm: <g>
  time: <seconds>
  csv_data:<dim>,<k>,<n_refs>,<ndofs>

(solve_system leastsquaretest.cpp:83-119 + the csv line :303-309).
The reference registers no ctest for this executable; converged CG on the
default testmesh configuration is the parity criterion.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from saamge_jax.api import SAAMGePC
from saamge_jax.config import SolverOptions
from saamge_jax.fem.helmholtz import ls_helmholtz_blocks
from saamge_jax.fem.mesh import quad_mesh, read_mesh
from saamge_jax.solve.pcg import pcg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--mesh",
                    default="/root/reference/amg/test/mltest.mesh")
    ap.add_argument("--generate-mesh", type=int, default=0, metavar="N",
                    help="use an NxN quad mesh instead of --mesh")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-k", "--k", type=float, default=1.0)
    ap.add_argument("-b", "--beta", type=float, default=1.0)
    ap.add_argument("-r", "--n-refs", type=int, default=1)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--elems-per-agg", type=int, default=12)
    ap.add_argument("-ns", "--no-saamge", action="store_true",
                    help="unpreconditioned CG instead")
    args = ap.parse_args()

    mesh0 = quad_mesh(args.generate_mesh) if args.generate_mesh \
        else read_mesh(args.mesh)
    blocks = ls_helmholtz_blocks(k=args.k, beta=args.beta,
                                 n_refs=args.n_refs, mesh=mesh0,
                                 order=args.order)
    mesh = blocks.mesh
    nU = blocks.M.shape[0]
    A, b = blocks.monolithic()
    print(f"dim(R) = {nU}")
    print(f"dim(W) = {blocks.G.shape[0]}")
    print(f"dim(R+W) = {A.shape[0]}")

    t0 = time.time()
    mult = None
    if not args.no_saamge:
        opts = SolverOptions(theta=args.theta, correct_nulspace=False,
                             num_levels=2,
                             first_elems_per_agg=args.elems_per_agg,
                             elems_per_agg=args.elems_per_agg)
        # scalar block: all-boundary essential BCs (leastsquaretest.cpp:251)
        ess_u = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        prec_u = SAAMGePC(blocks.M, mesh, blocks.M_el, opts,
                          order=args.order, ess_attr_marker=ess_u)
        # vector block: no essential BCs (ess_bdr_vec = 0, :254-256)
        ess_w = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
        prec_w = SAAMGePC(blocks.G, mesh, blocks.G_el, opts,
                          order=args.order, vdim=2, ess_attr_marker=ess_w)

        def mult(r):
            return np.concatenate([prec_u.mult(r[:nU]),
                                   prec_w.mult(r[nU:])])

    res = pcg(A, b, mult or (lambda r: r.copy()),
              rel_tol=0.0, abs_tol=1e-10, max_iter=1000)
    dt = time.time() - t0
    if res.converged:
        print(f"n_iterations: {res.iterations}")
    else:
        print(f"Outer PCG failed to converge after {res.iterations} "
              "iterations!")
    print(f"final_norm: {res.final_norm:g}")
    print(f"time: {dt:g}")
    print(f"csv_data:{mesh.dim},{args.k:g},{args.n_refs},{A.shape[0]}")
    return res


if __name__ == "__main__":
    main()
