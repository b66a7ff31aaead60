"""Driver for the SPMD-decomposed setup (parallel/spmd_setup.py).

Builds a 3D Poisson problem, runs the rank-decomposed setup pipeline
(rank-local tables + explicit exchanges; optionally with the per-rank
compute mesh-sharded), reports per-rank peak memory and the exchange
ledger, checks the distributed RAP against the controller product, and
solves with the resulting hierarchy.

Usage: python scripts/run_spmd_setup.py [--n 16] [--ranks 8]
           [--levels 3] [--theta 0.003] [--device-compute]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.003)
    ap.add_argument("--elems-per-agg", type=int, default=64)
    ap.add_argument("--contrast", type=float, default=2.0)
    ap.add_argument("--device-compute", action="store_true",
                    help="shard the eigensolve/SVD batches over a "
                         "virtual CPU device mesh")
    ap.add_argument("--spmd-levels", type=int, default=1,
                    help="number of coarsenings run through the "
                         "rank-decomposed pipeline (recursive SPMD)")
    args = ap.parse_args()

    if args.device_compute:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{args.ranks}").strip()

    from saamge_jax.api import bdr_dof_flags
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import hex_mesh
    from saamge_jax.parallel.spmd_setup import spmd_ml_produce_data
    from saamge_jax.setup.ml import MultilevelParameters
    from saamge_jax.solve.pcg import pcg
    from saamge_jax.solve.vcycle import VCycleSolver

    mesh = hex_mesh(args.n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(0)
    coefs = 10.0 ** rng.uniform(-args.contrast, args.contrast,
                                mesh.num_elements)
    A, b, em, e2d, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    flags_arr = bdr_dof_flags(mesh, ess)
    e2e = mesh.elem_to_elem()

    setup_mesh = None
    if args.device_compute:
        import jax
        from jax.sharding import Mesh
        setup_mesh = Mesh(np.array(jax.devices("cpu")[:args.ranks]),
                          axis_names=("dp",))

    nparts0 = max(1, mesh.num_elements // args.elems_per_agg)
    nparts = [nparts0]
    for _ in range(args.levels - 2):
        nparts.append(max(1, nparts[-1] // args.elems_per_agg))
    mlp = MultilevelParameters(
        num_coarsenings=args.levels - 1, nparts_arr=nparts,
        first_theta=args.theta, theta=args.theta,
        use_correct_nullspace=False)

    t0 = time.perf_counter()
    ml, out = spmd_ml_produce_data(
        e2d, e2e, em, flags_arr, args.ranks, mlp, A=A,
        elems_per_agg=args.elems_per_agg, setup_mesh=setup_mesh,
        spmd_coarsenings=args.spmd_levels)
    t_setup = time.perf_counter() - t0
    print(f"SPMD setup: {args.ranks} ranks, {t_setup:.1f}s, "
          f"{out.num_mises} MISes, {out.n_ae_total} AEs")
    print("per-rank peak MB:",
          [round(x / 1e6, 2) for x in out.peak_bytes_per_rank])
    for phase, st in out.ledger.summary().items():
        print(f"  exchange {phase}: total {st['bytes']/1e6:.3f} MB, "
              f"max/rank {st['max_rank_bytes']/1e6:.3f} MB, "
              f"{st['msgs']} msgs")
    rap_ref = (out.P.T @ A @ out.P).tocsr()
    print("dist RAP max diff vs controller:",
          abs(out.Ac - rap_ref).max())

    sol = VCycleSolver(ml.levels[0].tg_data)
    sol.set_operator(A)

    def prec(r):
        z = np.zeros_like(r)
        sol.mult(r, z)
        return z

    res = pcg(A, b, prec, rel_tol=1e-6, max_iter=200)
    print(f"Outer PCG converged in {res.iterations} iterations."
          if res.converged else
          f"Outer PCG FAILED after {res.iterations} iterations!")


if __name__ == "__main__":
    main()
