"""Large-problem setup scaling demonstration.

Runs the full flagship setup pipeline — Cartesian hex mesh, slab-add
stencil assembly, brick partitioning, spectral AE coarsening (batched
device pipeline with --device-setup, host eigensolver otherwise),
multilevel hierarchy — at multi-million-dof sizes on one host + one
device, and prints one JSON line with per-phase wall times and peak RSS.

The reference demonstrates the same scaling through MPI process counts
(mltest.cpp with an SPE10-sized run, aggregates.cpp:712-831 distributed
tables); the single-controller analog is host-memory-bounded setup with
device-offloaded numerics, so the relevant budget here is host RAM and
wall time.

Usage: python scripts/run_scale_setup.py [--n 200] [--levels 3]
       (n=200 -> 8.12M dofs)

``--hier-cache PATH``: after setup, pickle a minimal "solve bundle"
(exactly the host arrays compile_structured consumes) to PATH; when
PATH already exists, skip setup and solve from the bundle, so a solve
can be rerun without repeating a long setup.
"""

import argparse
import json
import os
import pickle
import resource
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def start_rss_trace(period: float = 2.0):
    """Background sampler: (t, rss_gb, phase) lines to stderr, phase
    read from TIMERS' active stack — attributes the RSS peak to a setup
    phase."""
    import atexit
    import threading

    from saamge_jax.utils.logging import TIMERS
    stop = threading.Event()
    peak_by_phase = {}

    def summary():
        print("[rss] per-phase current-RSS peaks: "
              + json.dumps({k: round(v, 2)
                            for k, v in sorted(peak_by_phase.items(),
                                               key=lambda kv: -kv[1])}),
              file=sys.stderr, flush=True)

    def pump():
        t0 = time.monotonic()
        while not stop.wait(period):
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
            try:
                with open("/proc/self/statm") as f:
                    cur = int(f.read().split()[1]) * os.sysconf(
                        "SC_PAGE_SIZE") / 1e9
            except Exception:
                cur = rss
            phase = ".".join(getattr(TIMERS, "stack", [])) or "-"
            if cur > peak_by_phase.get(phase, 0.0):
                peak_by_phase[phase] = cur
                print(f"[rss +{time.monotonic()-t0:7.1f}s] cur={cur:6.2f}G"
                      f" peak={rss:6.2f}G  {phase}",
                      file=sys.stderr, flush=True)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    # the attribution table must survive any exit path (the daemon
    # thread is killed mid-wait at interpreter shutdown)
    atexit.register(summary)
    return stop


def solve_bundle(ml, b, out, supers=None):
    """Minimal picklable shim of the attributes compile_structured
    reads (solve/structured.py:565-647)."""
    lv0, lv1 = ml.levels[0], ml.levels[1]
    rels = lv0.rels
    rels1 = lv1.rels
    tg0, tg1 = lv0.tg_data, lv1.tg_data
    ml_shim = types.SimpleNamespace(levels=[
        types.SimpleNamespace(
            A=lv0.A,
            rels=types.SimpleNamespace(
                num_mises=rels.num_mises, mis_to_AE=rels.mis_to_AE,
                nparts=rels.nparts),
            tg_data=types.SimpleNamespace(
                smooth_interp=tg0.smooth_interp,
                poly_data=tg0.poly_data, tent_interp=tg0.tent_interp,
                interp_data=types.SimpleNamespace(
                    mis_numcoarsedof=tg0.interp_data.mis_numcoarsedof),
                Ac=tg0.Ac)),
        types.SimpleNamespace(
            rels=types.SimpleNamespace(
                num_mises=rels1.num_mises, mis_to_AE=rels1.mis_to_AE,
                nparts=rels1.nparts),
            tg_data=types.SimpleNamespace(
                smooth_interp=tg1.smooth_interp,
                restr=tg1.restr, tent_interp=tg1.tent_interp,
                interp_data=types.SimpleNamespace(
                    mis_numcoarsedof=tg1.interp_data.mis_numcoarsedof),
                poly_data=tg1.poly_data, Ac=tg1.Ac)),
    ])
    return {"ml": ml_shim, "b": b, "out": out, "supers": supers}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--brick", type=int, default=8)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--theta", type=float, default=1e-4)
    ap.add_argument("--contrast", type=float, default=2.0)
    ap.add_argument("--device-setup", action="store_true",
                    help="batched device eigensolver pipeline "
                         "(default: host float64 eigensolver)")
    ap.add_argument("--solve", action="store_true",
                    help="also compile the structured hierarchy and run "
                         "a PCG solve on the default device")
    ap.add_argument("--hier-cache", type=str, default=None,
                    help="pickle the solve bundle here / reuse it")
    ap.add_argument("--device-rap", action="store_true",
                    help="Galerkin product on device (setup/device_rap"
                         ".py; with --device-setup)")
    ap.add_argument("--supers", type=int, default=0,
                    help="superbrick grid side for the 3rd level "
                         "(0 = auto: divisor of nb nearest nb/4; "
                         "-1 = unstructured kway + dense R1)")
    ap.add_argument("--rss-trace", action="store_true",
                    help="sample current RSS every 2 s with the active "
                         "TIMERS phase (peak-memory attribution)")
    args = ap.parse_args()
    if args.rss_trace:
        start_rss_trace()

    import jax
    nb = args.n // args.brick

    if args.hier_cache and os.path.exists(args.hier_cache):
        with open(args.hier_cache, "rb") as f:
            bundle = pickle.load(f)
        ml_obj, b, out = bundle["ml"], bundle["b"], bundle["out"]
        supers = bundle.get("supers")
        out["from_cache"] = True
        ndof = out["ndof"]
    else:
        from saamge_jax.api import SpectralAMGSolver
        from saamge_jax.config import SolverOptions
        from saamge_jax.fem import assemble
        from saamge_jax.fem.mesh import hex_mesh
        from saamge_jax.topology.part import partition_cartesian_3d
        from saamge_jax.utils.logging import TIMERS

        phases = {}
        t0 = time.perf_counter()
        mesh = hex_mesh(args.n)
        phases["mesh_s"] = round(time.perf_counter() - t0, 2)

        rng = np.random.default_rng(7)
        coefs = 10.0 ** rng.uniform(-args.contrast, args.contrast,
                                    mesh.num_elements)
        ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        t0 = time.perf_counter()
        # lazy_elem_mats: the factorized uniform-mesh batch (16.8 GB
        # saved at n=320; the setup paths consume it directly)
        A, b, em, _, _ = assemble.build_discrete_problem(
            mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess,
            lazy_elem_mats=True)
        phases["assemble_s"] = round(time.perf_counter() - t0, 2)
        ndof = A.shape[0]

        t0 = time.perf_counter()
        part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
        phases["partition_s"] = round(time.perf_counter() - t0, 2)

        sgrid = args.supers
        if sgrid == 0:
            sgrid = min((d for d in range(1, nb + 1) if nb % d == 0),
                        key=lambda d: abs(d - nb / 4))
        supers = (sgrid,) * 3 if (args.levels >= 3 and sgrid > 1) \
            else None
        if supers:
            from saamge_jax.topology.part import partition_cartesian_bricks
            override = lambda i: partition_cartesian_bricks(  # noqa: E731
                (nb,) * 3, supers)
        else:
            override = None
        opts = SolverOptions(
            num_levels=args.levels, correct_nulspace=False,
            first_theta=args.theta, theta=args.theta, nu_relax=[3, 1],
            device_setup=args.device_setup)
        rap_override = None
        if args.device_rap and args.device_setup:
            from saamge_jax.setup.device_rap import \
                make_structured_rap_override
            from saamge_jax.solve.structured import BrickGeometry
            rap_override = make_structured_rap_override(
                BrickGeometry((nb,) * 3, (args.brick,) * 3))
        t0 = time.perf_counter()
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                              partitioning=part,
                              coarse_part_override=override,
                              rap_override=rap_override)
        phases["setup_s"] = round(time.perf_counter() - t0, 2)
        phases["setup_device_pipeline_s"] = round(
            TIMERS.total("setup.device_pipeline"), 2)
        phases["setup_eig_phase_s"] = round(
            TIMERS.total("setup.device_pipeline.eigh"), 2)
        phases["setup_rap_s"] = round(TIMERS.total("setup.rap"), 2)
        phases["setup_rap_device_s"] = round(
            TIMERS.total("setup.rap_device"), 2)
        # full accumulating-timer dump: localizes the host setup tail
        # (everything in setup_s outside the device pipeline)
        phases["timers"] = {k: round(v, 2)
                            for k, v in sorted(TIMERS.totals.items())}

        out = {
            "metric": f"scale_setup_n{ndof}",
            "ndof": ndof,
            "levels": [lv.A.shape[0] for lv in s.ml.levels]
            + [s.ml.levels[-1].tg_data.Ac.shape[0]],
            "nnz": int(A.nnz),
            "phases": phases,
            "total_s": round(sum(v for k, v in phases.items()
                                 if k.endswith("_s")
                                 and not k.startswith("setup_device")
                                 and k != "setup_eig_phase_s"
                                 and k != "setup_rap_s"), 2),
            "peak_rss_gb": round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
                2),
            "platform": jax.devices()[0].platform,
        }
        ml_obj = s.ml
        if args.hier_cache:
            bundle = solve_bundle(s.ml, b, out, supers=supers)
            with open(args.hier_cache + ".tmp", "wb") as f:
                pickle.dump(bundle, f)
            os.replace(args.hier_cache + ".tmp", args.hier_cache)
            out["hier_cache"] = args.hier_cache

    if args.solve:
        import jax.numpy as jnp
        from saamge_jax.solve.structured import (BrickGeometry,
                                                 compile_structured,
                                                 struct_pcg_solve)
        geo = BrickGeometry((nb, nb, nb), (args.brick,) * 3)
        t0 = time.perf_counter()
        h = compile_structured(ml_obj, geo, mid_dtype=jnp.bfloat16,
                               smoother_dtype=jnp.bfloat16,
                               rp_dtype=jnp.bfloat16, super_bricks=supers)
        out["supers"] = supers
        out["compile_s"] = round(time.perf_counter() - t0, 2)
        bdev = jnp.asarray(b, jnp.float32)
        x, iters, relres = struct_pcg_solve(h, bdev, max_iter=200)
        out["pcg_iters"] = int(iters)
        out["rel_res"] = float(relres)

        R = 20

        @jax.jit
        def chain(hier, b0):
            def body(c, _):
                return hier.vcycle(b0, c), ()
            y, _ = jax.lax.scan(body, jnp.zeros_like(b0), jnp.zeros(R))
            return jnp.sum(y)
        float(chain(h, bdev))
        t0 = time.perf_counter()
        float(chain(h, bdev * 1.000001))
        dt = (time.perf_counter() - t0) / R
        out["vcycle_ms"] = round(dt * 1e3, 3)
        out["dofs_per_sec"] = round(ndof / dt, 1)
        dev = jax.devices()[0]
        out["device"] = {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(jax.devices())}
        ms = dev.memory_stats() or {}
        out["peak_device_gb"] = round(
            ms.get("peak_bytes_in_use", 0) / 1e9, 2)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
