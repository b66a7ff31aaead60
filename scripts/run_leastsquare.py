"""Driver mirroring `leastsquarealgebraictest` (FOSLS Helmholtz + algebraic
SAAMGe PCG).  Prints the reference's csv line:
  csv_data:<dim>,<k>,<n_refs>,<dofs>,<iterations>,<final_norm>

ctest baselines (amg/CMakeLists.txt:236-250):
  k=-20: csv_data:2,-20,2,803,56   |  k=-50: csv_data:2,-50,2,803,115
"""

import argparse
import sys

sys.path.insert(0, ".")

from saamge_jax.api import SAAMGeAlgPC
from saamge_jax.config import SolverOptions
from saamge_jax.fem.helmholtz import ls_helmholtz_system
from saamge_jax.solve.pcg import pcg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-k", "--k", type=float, default=1.0)
    ap.add_argument("-b", "--beta", type=float, default=0.99)
    ap.add_argument("-r", "--n-refs", type=int, default=2)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--no-saamge", action="store_true",
                    help="plain (unpreconditioned) CG instead")
    args = ap.parse_args()

    sys_ = ls_helmholtz_system(k=args.k, beta=args.beta, n_refs=args.n_refs)
    mult = None
    if not args.no_saamge:
        opts = SolverOptions(theta=args.theta, correct_nulspace=False,
                             first_elems_per_agg=256, rtol=0.0, maxiter=600)
        pc = SAAMGeAlgPC(sys_.A, opts, eliminate_dof0=False)
        mult = pc.mult
    res = pcg(sys_.A, sys_.b, mult or (lambda r: r.copy()),
              rel_tol=0.0, abs_tol=1e-10, max_iter=600)
    print(f"csv_data:2,{args.k:g},{args.n_refs},{sys_.A.shape[0]},"
          f"{res.iterations},{res.final_norm:g}")
    u, q = sys_.recover(res.x)
    print(f"|u|_inf = {abs(u).max():g}, |q|_inf = {abs(q).max():g}")


if __name__ == "__main__":
    main()
