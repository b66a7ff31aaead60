"""General-path (non-Cartesian) device throughput measurement.

Every recorded DOFs/s figure so far is the structured brick fast path;
the reference is mesh-agnostic (METIS partitioning of arbitrary dual
graphs, /root/reference/amg/src/part.cpp:120-204) and its users on
arbitrary meshes would hit our GENERAL device path:
`solve/compiled.py` — DIA / RCM-banded / ELL operators picked by
structure, MIS-block-row coarse levels, the jitted multilevel V-cycle
(tg_cycle_atb, tg.cpp:91).  This driver records that number.

Two problems:
  --problem hexkway  (default): 3D Poisson on a hex mesh (``--n``,
      default 100 -> 1,030,301 dofs) with random high-contrast
      coefficients, agglomerated by the GENERIC multilevel k-way
      partitioner (native/partition.cpp — the METIS analog), NOT the
      Cartesian brick fast path.  Fine level is still a 27-point
      stencil (any hex mesh is), so DIA engages there; the coarse
      levels and transfer operators are fully unstructured.
  --problem tet: the reference's own cube474 tet mesh
      (amg/data/meshes/cube474.mesh3d, ctest 'cube' config theta=1e-4)
      uniformly refined ``--refs`` times (default 4 -> 1.94M tets,
      ~341k dofs): unstructured sparsity end to end — the fine
      operator is NOT a stencil and the format picker falls back to
      banded/ELL.

Timing follows bench.py: the whole rep-chain runs inside one jitted
scan, timed after a warm-up call.  The setup product is cached in
.bench_cache/ so re-runs skip the host setup.

Prints ONE bench-schema JSON line naming the device it ran on.
"""

import argparse
import json
import os
import pickle
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np

CUBEMESH = "/root/reference/amg/data/meshes/cube474.mesh3d"


def build_problem(args):
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import hex_mesh, read_mesh

    if args.problem == "hexkway":
        mesh = hex_mesh(args.n)
        rng = np.random.default_rng(7)
        coef = 10.0 ** rng.uniform(-args.contrast, args.contrast,
                                   mesh.num_elements)
        theta = 1e-4
    else:
        mesh = read_mesh(CUBEMESH).refined_times(args.refs)
        coef = 1.0
        theta = 1e-4        # ctest 'cube' (amg/test/CMakeLists.txt:64-71)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    return mesh, A, b, em, ess, theta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", choices=("hexkway", "tet"),
                    default="hexkway")
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--refs", type=int, default=4)
    ap.add_argument("--contrast", type=float, default=2.0)
    ap.add_argument("--elems-per-agg", type=int, default=512)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--device-setup", action="store_true",
                    help="batched device eigensolver pipeline "
                         "(default: host float64 eigensolver)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    dev = jax.devices()[0]

    tag = (f"{args.problem}_n{args.n}" if args.problem == "hexkway"
           else f"{args.problem}_r{args.refs}")
    cpath = os.path.join(_REPO, ".bench_cache",
                         f"general_{tag}_L{args.levels}"
                         f"_e{args.elems_per_agg}.pkl")
    extra = {"problem": args.problem, "platform": dev.platform,
             "device": {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}}

    if not args.no_cache and os.path.exists(cpath):
        with open(cpath, "rb") as f:
            d = pickle.load(f)
        ml, A, b, meta = d["ml"], d["A"], d["b"], d["meta"]
        extra.update(meta)
        extra["setup_from_cache"] = True
        ndof = A.shape[0]
    else:
        from saamge_jax.api import SpectralAMGSolver
        from saamge_jax.config import SolverOptions

        t0 = time.perf_counter()
        mesh, A, b, em, ess, theta = build_problem(args)
        assemble_s = round(time.perf_counter() - t0, 2)
        ndof = A.shape[0]
        print(f"[general] {args.problem}: ndof={ndof} "
              f"ne={mesh.num_elements} assemble={assemble_s}s",
              file=sys.stderr, flush=True)

        opts = SolverOptions(
            num_levels=args.levels, correct_nulspace=False,
            first_theta=theta, theta=theta,
            nu_relax=[3, 1] if args.levels >= 3 else 3,
            first_elems_per_agg=args.elems_per_agg,
            elems_per_agg=args.elems_per_agg,
            device_setup=args.device_setup)
        t0 = time.perf_counter()
        # partitioning=None => generic dual-graph k-way partitioner
        # (native/partition.cpp), the METIS-analog general path
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
        setup_s = round(time.perf_counter() - t0, 2)
        ml = s.ml
        meta = {"ndof": ndof, "ne": mesh.num_elements,
                "theta": theta, "assemble_s": assemble_s,
                "setup_s": setup_s,
                "coarse_dims": [lv.tg_data.Ac.shape[0]
                                for lv in ml.levels]}
        extra.update(meta)
        extra["setup_from_cache"] = False
        if not args.no_cache:
            os.makedirs(os.path.dirname(cpath), exist_ok=True)
            with open(cpath + ".tmp", "wb") as f:
                pickle.dump({"ml": ml, "A": A, "b": b, "meta": meta}, f)
            os.replace(cpath + ".tmp", cpath)

    from saamge_jax.solve.compiled import (compile_hierarchy, pcg_solve,
                                           vcycle)

    t0 = time.perf_counter()
    h = compile_hierarchy(ml, dtype=jnp.float32)
    extra["compile_s"] = round(time.perf_counter() - t0, 2)
    extra["formats"] = [type(lv.A).__name__ for lv in h.levels]

    bdev = jnp.asarray(b, jnp.float32)
    x, iters, _ = pcg_solve(h, bdev, rel_tol=1e-6, max_iter=300)
    extra["pcg_iters_1e-6"] = int(iters)
    _, iters8, _ = pcg_solve(h, bdev, rel_tol=1e-8, max_iter=300)
    extra["pcg_iters_1e-8"] = int(iters8)

    R = args.reps

    @jax.jit
    def chain(hier, b0):
        def body(c, _):
            return vcycle(hier, b0, c), ()
        y, _ = jax.lax.scan(body, jnp.zeros_like(b0), jnp.zeros(R))
        return jnp.sum(y)

    float(chain(h, bdev))
    t0 = time.perf_counter()
    float(chain(h, bdev * 1.000001))
    dt = (time.perf_counter() - t0) / R
    extra["vcycle_ms"] = round(dt * 1e3, 3)

    payload = {
        "metric": f"3d_general_{args.problem}_vcycle_dofs_per_sec_"
                  f"{extra['platform']}_n{ndof}_L{args.levels}",
        "value": round(ndof / dt, 1),
        "unit": "dofs/s",
        "vs_baseline": 0.0,
        "extra": extra,
    }
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
