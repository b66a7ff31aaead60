"""Driver mirroring `startfromcoarse` (test/startfromcoarse/
startfromcoarse.cpp): take the canonical spectral coarsening of a fine
problem, then treat the COARSE problem as the problem of interest — build
a multilevel hierarchy on it and solve.  Emits a JSON experiment record
(the reference uses vendored picojson + readjson.py)."""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from saamge_jax.api import SAAMGeAlgPC, SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import quad_mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--first-theta", type=float, default=0.003)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--nu-pro", type=int, default=0)
    ap.add_argument("--nu-relax", type=int, default=3)
    ap.add_argument("--elems-per-agg", type=int, default=128)
    ap.add_argument("--minimal-coarse", action="store_true")
    args = ap.parse_args()

    record = {"invocation": "run_startfromcoarse", "processors": 1,
              "args": vars(args), "timings": {}}

    mesh = quad_mesh(args.n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)

    t0 = time.perf_counter()
    fine = SpectralAMGSolver(
        A, mesh, em,
        SolverOptions(theta=args.first_theta, num_levels=2,
                      correct_nulspace=False,
                      first_elems_per_agg=args.elems_per_agg),
        ess_attr_marker=ess)
    record["timings"]["first_coarsening"] = time.perf_counter() - t0
    tg = fine.ml.finest.tg_data
    Ac, bc = tg.Ac.tocsr(), tg.restr @ b
    record["fine_dim"] = A.shape[0]
    record["coarse_dim"] = Ac.shape[0]

    t0 = time.perf_counter()
    pc = SAAMGeAlgPC(
        Ac, SolverOptions(theta=args.theta, nu_pro=args.nu_pro,
                          nu_relax=args.nu_relax, correct_nulspace=False,
                          minimal_coarse=args.minimal_coarse,
                          first_elems_per_agg=args.elems_per_agg),
        eliminate_dof0=False)
    record["timings"]["coarse_setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pc.solve(bc)
    record["timings"]["coarse_solve"] = time.perf_counter() - t0
    record["iterations"] = res.iterations
    record["converged"] = bool(res.converged)
    print(json.dumps(record, indent=1))


if __name__ == "__main__":
    main()
