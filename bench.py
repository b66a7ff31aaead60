"""Benchmark: multilevel V-cycle throughput on 3D Poisson (the BASELINE
metric — DOFs/sec of the solve-phase hot loop, reference tg_cycle_atb,
tg.cpp:91-131).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "dofs/s", "vs_baseline": N,
   "extra": {..., "device": {"platform", "kind", "count"}}}

Process architecture: a SUPERVISOR parent (which never imports JAX, so
the measurement child is the only process on the device) spawns the
measurement as a child process that writes a progressively-enriched
result snapshot to a status file after every milestone (setup done ->
compiled -> V-cycle measured [primary] -> traffic model -> optional
component timings).  The parent enforces a wall-clock ``--budget``: if
the child overruns, the parent kills it and prints the LAST COMPLETE
snapshot, so a slow run degrades the artifact's detail, never its
existence.

A run fails when JAX finds no GPU, unless the CPU was asked for
explicitly (JAX_PLATFORMS=cpu); every result names the platform, the
device kind and the device count.

Setup caching: the host setup product is pickled to ``.bench_cache/``
keyed by (n, brick, levels, theta, contrast, bundle-version); a rerun in
the same checkout loads the bundle and goes straight to the solve-phase
measurement.

Measurement semantics:
- vs_baseline is MEASURED: the same V-cycle applied through scipy-CSR
  host kernels on this machine (the reference's serial hypre path is the
  same algorithm over the same kind of CSR kernels).
- format_fraction compares the measured V-cycle time against the bytes
  the chosen formats and dtypes stream per cycle, at the device's
  stream rate measured in the same process right before (large XLA
  triad and read chains).
- The problem chooses the path: the structured brick hierarchy
  (solve/structured.py) when ``n`` is a multiple of ``--brick``,
  otherwise the general compiled hierarchy (solve/compiled.py).
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import types

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

import numpy as np

BUNDLE_VERSION = 2


# ----------------------------------------------------------------------
# snapshot emitter: the child's contract with the supervisor

class Emitter:
    def __init__(self, path):
        self.path = path
        self.payload = None

    def emit(self, payload):
        self.payload = payload
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


def _skeleton(stage, device=None, **extra):
    e = {"stage": stage, "device": device}
    e.update(extra)
    return {"metric": "bench_incomplete", "value": 0.0, "unit": "dofs/s",
            "vs_baseline": 0.0, "extra": e}


# ----------------------------------------------------------------------
# device stream rate

def measure_peak_stream(jnp, jax):
    """Device stream rate (GB/s): max over two plain-XLA chains over
    256 MB buffers, each step separated by an optimization barrier so
    XLA cannot collapse the chain:

    (a) triad: c = |c| + 0.5 b_r, read-c + read-b + write-c = 12 N
        bytes per step;
    (b) read-reduce: max(b_r * s), 4 N bytes per step (the stencil
        passes are mostly reads).

    Both raw readings are reported."""
    N = 64 * 1024 * 1024            # 256 MB per buffer
    K = 4

    def run(fn, c0, ops, traffic):
        float(fn(c0, *ops))
        t0 = time.perf_counter()
        float(fn(c0 * (1.0 + 1e-7), *ops))
        return traffic / (time.perf_counter() - t0) / 1e9

    bufs = tuple(jnp.full(N, 1.0 + 0.1 * i, jnp.float32)
                 for i in range(K))
    c0 = jnp.ones(N, jnp.float32)
    R = 64

    @jax.jit
    def f_triad(c, *bs):
        # statically-indexed buffers (a dynamic index would copy the
        # 256 MB slice first)
        for r in range(R):
            c = jnp.abs(c) + 0.5 * bs[r % K]
            c = jax.lax.optimization_barrier(c)
        return jnp.sum(c)

    @jax.jit
    def f_read(c, *bs):
        acc = jnp.float32(0.0) * c[0]
        for r in range(R):
            acc = jax.lax.optimization_barrier(
                acc + jnp.max(bs[r % K] * (1.0 + acc * 1e-30)))
        return acc

    gb_triad = run(f_triad, c0, bufs, R * 3 * N * 4)
    gb_read = run(f_read, c0, bufs, R * N * 4)
    del bufs, c0
    raw = {"xla_triad": round(gb_triad, 1), "read": round(gb_read, 1)}
    return max(gb_triad, gb_read), raw


# ----------------------------------------------------------------------
# setup bundle (cacheable minimal solve product)

def _ml_shim(ml):
    """Minimal picklable shim of the attributes compile_structured
    reads (solve/structured.py) — same shape as
    scripts/run_scale_setup.solve_bundle, kept standalone so bench.py
    has no scripts/ dependency."""
    lv0, lv1 = ml.levels[0], ml.levels[1]
    rels = lv0.rels
    rels1 = lv1.rels
    tg0, tg1 = lv0.tg_data, lv1.tg_data
    return types.SimpleNamespace(levels=[
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


def _level_stats(ml):
    stats = []
    for lv in ml.levels:
        tg = lv.tg_data
        stats.append({
            "n": int(lv.A.shape[0]), "nnz": int(lv.A.nnz),
            "deg": int(len(tg.poly_data.roots)),
            "interp_nnz": int(tg.interp.nnz),
            "restr_nnz": int(tg.restr.nnz),
            "interp_rows": int(tg.interp.shape[0]),
            "interp_cols": int(tg.interp.shape[1]),
            "Ac_n": int(tg.Ac.shape[0]),
        })
    return stats


def _cache_path(cache_dir, n, brick, levels, theta, contrast):
    key = f"n{n}_b{brick}_L{levels}_t{theta:g}_c{contrast:g}_v{BUNDLE_VERSION}"
    return os.path.join(cache_dir, f"bundle_{key}.pkl")


# ----------------------------------------------------------------------
# the measurement (child process)

def device_info(jax):
    """The device the run measures; fails without a GPU unless the CPU
    was asked for explicitly."""
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(f"bench: no GPU (default device is "
                         f"{dev.platform}); set JAX_PLATFORMS=cpu to "
                         f"measure the CPU on purpose")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def run_bench(args):
    emit = Emitter(args.status_file)
    emit.emit(_skeleton("start"))

    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # CPU backend => no persistent compile cache (machine-feature-
        # mismatched CPU AOT loads segfault; saamge_jax.__init__)
        import saamge_jax
        saamge_jax.disable_compile_cache()
    import jax.numpy as jnp

    device = device_info(jax)
    n = args.n or (16 if args.small else 96)
    structured = n % args.brick == 0
    ndof_expect = (n + 1) ** 3
    theta = args.theta
    if theta == 0.0:
        # keep the coarse space dense-inverse-sized at scale
        theta = 0.003 if ndof_expect < 2_000_000 else 1e-4

    emit.emit(_skeleton("device", device, n=n))

    from saamge_jax.utils.logging import TIMERS

    # --- setup (cached when possible) ---------------------------------
    cpath = _cache_path(args.cache_dir, n, args.brick, args.levels,
                        theta, args.contrast)
    bundle = None
    if structured and not args.no_cache and os.path.exists(cpath):
        try:
            with open(cpath, "rb") as f:
                bundle = pickle.load(f)
            if bundle.get("version") != BUNDLE_VERSION:
                bundle = None
        except Exception as e:                      # corrupt cache
            print(f"[bench] cache load failed: {e}", file=sys.stderr)
            bundle = None
    from_cache = bundle is not None

    if from_cache:
        ml = bundle["ml"]
        b = bundle["b"]
        supers = bundle["supers"]
        level_stats = bundle["level_stats"]
        coarse_dims = bundle["coarse_dims"]
        host_dt = bundle["host_vcycle_ms"] / 1e3
        setup_times = bundle["setup"]
        ndof = bundle["ndof"]
        nb = n // args.brick
        print(f"[bench] setup bundle loaded from {cpath}", file=sys.stderr)
    else:
        from saamge_jax.api import SpectralAMGSolver
        from saamge_jax.config import SolverOptions
        from saamge_jax.fem import assemble
        from saamge_jax.fem.mesh import hex_mesh

        t0 = time.perf_counter()
        mesh = hex_mesh(n)
        ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        rng = np.random.default_rng(7)
        coefs = 10.0 ** rng.uniform(-args.contrast, args.contrast,
                                    mesh.num_elements)
        A, b, em, _, _ = assemble.build_discrete_problem(
            mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
        assemble_s = time.perf_counter() - t0
        ndof = A.shape[0]

        t0 = time.perf_counter()
        if structured:
            from saamge_jax.topology.part import (
                partition_cartesian_3d, partition_cartesian_bricks)
            nb = n // args.brick
            part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
            # superbrick 3rd-level partitioning (~64 bricks per
            # superbrick) keeps the coarsest restriction block-diagonal
            # (solve/structured.py build_structured_interp2)
            sgrid = min((d for d in range(1, nb + 1) if nb % d == 0),
                        key=lambda d: abs(d - nb / 4))
            supers = (sgrid,) * 3 if (args.levels >= 3 and sgrid > 1) \
                else None
            override = (lambda i: partition_cartesian_bricks(
                (nb,) * 3, supers)) if supers else None
            opts = SolverOptions(
                num_levels=args.levels, correct_nulspace=False,
                first_theta=theta, theta=theta, nu_relax=[3, 1],
                device_setup=not args.host_setup)
            s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                                  partitioning=part,
                                  coarse_part_override=override)
        else:
            supers = None
            nb = 0
            num_levels = args.levels if ndof > 5000 else 2
            opts = SolverOptions(
                num_levels=num_levels, correct_nulspace=False,
                first_theta=theta, theta=theta,
                first_elems_per_agg=256, elems_per_agg=256,
                device_setup=False)
            s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
        setup_s = time.perf_counter() - t0
        setup_times = {
            "assemble_s": round(assemble_s, 2),
            "setup_s": round(setup_s, 2),
            "setup_device_pipeline_s": round(
                TIMERS.total("setup.device_pipeline"), 2),
            "setup_eig_phase_s": round(
                TIMERS.total("setup.device_pipeline.eigh"), 2),
            "setup_rr_refine_s": round(
                TIMERS.total("setup.device_pipeline.rr"), 2),
        }
        level_stats = _level_stats(s.ml)
        coarse_dims = [int(lv.tg_data.Ac.shape[0]) for lv in s.ml.levels]

        # --- measured CPU baseline: same V-cycle through scipy CSR ----
        from saamge_jax.solve.vcycle import VCycleSolver
        vs_host = VCycleSolver(s.ml.finest.tg_data)
        vs_host.set_operator(s.ml.finest.A)
        xh = np.zeros(ndof)
        vs_host.mult(b, xh)
        host_reps = 1 if ndof > 500_000 else 3
        t0 = time.perf_counter()
        for _ in range(host_reps):
            vs_host.mult(b, xh)
        host_dt = (time.perf_counter() - t0) / host_reps

        ml = s.ml
        if structured and not args.no_cache:
            os.makedirs(args.cache_dir, exist_ok=True)
            bundle = {
                "version": BUNDLE_VERSION, "ml": _ml_shim(s.ml), "b": b,
                "supers": supers, "level_stats": level_stats,
                "coarse_dims": coarse_dims,
                "host_vcycle_ms": host_dt * 1e3,
                "setup": setup_times, "ndof": ndof,
            }
            with open(cpath + ".tmp", "wb") as f:
                pickle.dump(bundle, f)
            os.replace(cpath + ".tmp", cpath)
            print(f"[bench] setup bundle cached to {cpath}",
                  file=sys.stderr)

    emit.emit(_skeleton("setup_done", device, ndof=ndof,
                        from_cache=from_cache, **setup_times))

    # --- compile the device hierarchy ---------------------------------
    t0 = time.perf_counter()
    if structured:
        from saamge_jax.solve.structured import (BrickGeometry,
                                                 compile_structured,
                                                 struct_pcg_solve)
        geo = BrickGeometry((nb, nb, nb), (args.brick,) * 3)
        # bf16 PRECONDITIONER storage (smoother diagonals, Rst, mid
        # blocks); the PCG operator matvec stays f32 (tests:
        # test_struct_full_bf16_preconditioner_iterations)
        h = compile_structured(ml, geo, mid_dtype=jnp.bfloat16,
                               smoother_dtype=jnp.bfloat16,
                               rp_dtype=jnp.bfloat16, super_bricks=supers)

        def vcycle_once(hier, b0, c):
            return hier.vcycle(b0, c)

        pcg = struct_pcg_solve
    else:
        from saamge_jax.solve.compiled import (compile_hierarchy,
                                               pcg_solve, vcycle)
        h = compile_hierarchy(ml, dtype=jnp.float32)

        def vcycle_once(hier, b0, c):
            return vcycle(hier, b0, c)

        pcg = lambda hh, bb, **kw: pcg_solve(hh, bb, **kw)  # noqa: E731
    compile_s = time.perf_counter() - t0

    bdev = jnp.asarray(b, jnp.float32)
    x, iters, _ = pcg(h, bdev, max_iter=200)
    iters = int(iters)
    # the BASELINE.json metric is iteration parity at tol 1e-8
    # (mltest.cpp:639,775 squares rel_tol): the tolerance is an
    # operand, so this reuses the compiled program
    _, iters8, _ = pcg(h, bdev, rel_tol=1e-8, max_iter=200)
    iters8 = int(iters8)

    emit.emit(_skeleton("compiled", device, ndof=ndof,
                        pcg_iters=iters, pcg_iters_1e_8=iters8,
                        compile_s=round(compile_s, 2)))

    # --- V-cycle timing: the whole rep chain inside ONE jitted call,
    # timed after a warm-up call of the same program
    R = args.reps

    @jax.jit
    def chain(hier, b0):
        def body(c, _):
            return vcycle_once(hier, b0, c), ()
        y, _ = jax.lax.scan(body, jnp.zeros_like(b0), jnp.zeros(R))
        return jnp.sum(y)

    float(chain(h, bdev))
    t0 = time.perf_counter()
    float(chain(h, bdev * 1.000001))
    dt = (time.perf_counter() - t0) / R
    dofs_per_sec = ndof / dt

    # ============ PRIMARY PAYLOAD (emitted before the enrichments) ====
    num_solve_levels = len(level_stats) + 1
    extra = {
        "ndof": ndof, "device": device, "platform": device["platform"],
        "structured": structured, "theta": theta,
        "setup_from_cache": from_cache,
        "coarse_dims": coarse_dims,
        "pcg_iters_1e-6": iters,
        "pcg_iters_1e-8": iters8,
        "vcycle_ms": round(dt * 1e3, 3),
        "host_vcycle_ms": round(host_dt * 1e3, 3),
        "compile_s": round(compile_s, 2),
        "stage": "primary",
    }
    extra.update(setup_times)
    payload = {
        "metric": f"3d_poisson_vcycle_dofs_per_sec_{device['platform']}"
                  f"_n{ndof}_L{num_solve_levels}",
        "value": round(dofs_per_sec, 1),
        "unit": "dofs/s",
        "vs_baseline": round(host_dt / dt, 3),
        "extra": extra,
    }
    emit.emit(payload)

    # --- format-traffic model (bytes the chosen formats stream) -------
    peak_gbps, raw_stream = (measure_peak_stream(jnp, jax)
                             if device["platform"] == "gpu"
                             else (0.0, {}))
    bytes_actual = 0.0
    level_detail = []
    for i, st in enumerate(level_stats):
        passes = 2 * st["deg"] + 1               # pre+post smooth + resid
        nrows = st["n"]
        if structured and i == 0:
            A0x = h.A0s if h.A0s is not None else h.A0
            npad0 = h.A0.n_rows_pad * 128
            ba = passes * (len(h.A0.offsets) * npad0
                           * A0x.vals2.dtype.itemsize + 3 * npad0 * 4)
            ba += (h.Rst.size * h.Rst.dtype.itemsize
                   + 2 * h.Rst.shape[2] * h.Rst.shape[0] * 4
                   + 2 * nrows * 4)
        elif structured and i == 1:
            from saamge_jax.solve.structured import BrickBlockOp
            if isinstance(h.A1d, BrickBlockOp):
                ba = passes * (h.A1d.traffic_bytes
                               + 3 * h.dinv1.shape[0] * 4)
            else:
                ba = passes * (nrows * nrows * h.A1d.dtype.itemsize
                               + 3 * nrows * 4)
            # coarsest restriction/prolongation stream (block-diagonal
            # superbrick tent blocks, or the dense R1 twice)
            if h.Rst1 is not None:
                ba += 2 * h.Rst1.size * h.Rst1.dtype.itemsize
            elif h.R1 is not None:
                ba += 2 * h.R1.size * h.R1.dtype.itemsize
        else:
            ba = passes * (st["nnz"] + 3 * nrows) * 4
            ba += (st["interp_nnz"] + st["restr_nnz"]
                   + 2 * (st["interp_rows"] + st["interp_cols"])) * 4
        bytes_actual += ba
        det = {"n": nrows, "passes": passes,
               "actual_mb": round(ba / 1e6, 1)}
        if peak_gbps:
            det["stream_ms"] = round(ba / (peak_gbps * 1e9) * 1e3, 3)
        level_detail.append(det)
    n2 = level_stats[-1]["Ac_n"]
    bytes_actual += (n2 * n2 + 2 * n2) * 4         # coarsest dense solve
    format_ms = bytes_actual / (peak_gbps * 1e9) * 1e3 if peak_gbps \
        else None
    extra.update({
        "peak_stream_gbps": round(peak_gbps, 1),
        "measured_stream_gbps": raw_stream,
        "format_traffic_mb": round(bytes_actual / 1e6, 1),
        "format_traffic_ms": (None if format_ms is None
                              else round(format_ms, 3)),
        "format_fraction": (None if format_ms is None
                            else round(format_ms / (dt * 1e3), 3)),
        "levels": level_detail,
        "stage": "models",
    })
    emit.emit(payload)

    # --- measured per-component times (opt-in) ------------------------
    if args.components and structured:
        measured = {}

        def timed_chain(name, body_fn, carry0, reps_c, operands=()):
            # large arrays arrive through ``operands`` (traced jit args)
            # so they are not embedded as program constants; UNROLL=4
            # applications per scan step, like the cycle composes ops
            unroll = 4
            steps = max(1, reps_c // unroll)

            @jax.jit
            def cchain(c0, *ops):
                def body(c, _):
                    for _ in range(unroll):
                        c = body_fn(c, *ops)
                    return c, ()
                y, _ = jax.lax.scan(body, c0, jnp.zeros(steps))
                return jax.tree_util.tree_reduce(
                    lambda a, v: a + jnp.sum(v), y, jnp.float32(0.0))
            float(cchain(carry0, *operands))
            tc = time.perf_counter()
            float(cchain(carry0, *operands))
            measured[name] = round(
                (time.perf_counter() - tc) / (steps * unroll) * 1e3, 4)
            extra["measured_components"] = measured
            emit.emit(payload)

        bh = h.pad0(bdev)
        xh0 = h.pad0(jnp.ones(ndof, jnp.float32))
        it0 = h.taus0[0]
        # measure the operator the PRECONDITIONER actually streams (the
        # bf16 twin when present), not the f32 PCG matvec operator
        timed_chain("l0_root_pass_ms",
                    lambda xh, hh: (hh.A0s or hh.A0).root_h(
                        it0, bh, hh.dinv0h, xh),
                    xh0, 400, operands=(h,))
        timed_chain("l0_residual_ms",
                    lambda xh, hh: (hh.A0s or hh.A0).residual_h(bh, xh),
                    xh0, 400, operands=(h,))
        res0 = jnp.ones(ndof, jnp.float32)
        timed_chain(
            "apply_R_ms",
            lambda c, hh: jnp.sum(hh.apply_R(res0 * (1 + 1e-12 * c))),
            jnp.float32(0.0), 200, operands=(h,))
        xcf = jnp.ones(h.n_flat, jnp.float32)
        timed_chain(
            "apply_P_ms",
            lambda c, hh: jnp.sum(hh.apply_P(xcf * (1 + 1e-12 * c))),
            jnp.float32(0.0), 200, operands=(h,))
        if h.A1d is not None:
            n_mid = h.dinv1.shape[0]
            timed_chain("mid_matvec_ms",
                        lambda x, hh: hh._mid_matvec(x),
                        jnp.ones(n_mid, jnp.float32), 300, operands=(h,))
            timed_chain(
                "coarsest_ms",
                lambda x, hh: x + hh._coarsest_correct(x),
                jnp.ones(n_mid, jnp.float32), 300, operands=(h,))
            deg0 = len(h.taus0)
            deg1 = len(h.taus1)
            explained = (2 * deg0 * measured["l0_root_pass_ms"]
                         + measured["l0_residual_ms"]
                         + measured["apply_R_ms"]
                         + measured["apply_P_ms"]
                         + (2 * deg1 + 1) * measured["mid_matvec_ms"]
                         + measured["coarsest_ms"])
            measured["explained_ms"] = round(explained, 3)
            measured["unexplained_ms"] = round(dt * 1e3 - explained, 3)
        extra["measured_components"] = measured

    extra["stage"] = "complete"
    emit.emit(payload)
    return payload


# ----------------------------------------------------------------------

def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny problem (CI / CPU smoke)")
    ap.add_argument("--n", type=int, default=0,
                    help="hex mesh resolution (elements per side)")
    ap.add_argument("--brick", type=int, default=8,
                    help="brick side length in elements")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.0,
                    help="spectral tolerance (0 = size-based default)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--contrast", type=float, default=2.0,
                    help="log10 range of the random element coefficient")
    ap.add_argument("--host-setup", action="store_true",
                    help="force the host (numpy f64) setup path")
    ap.add_argument("--budget", type=float, default=1100.0,
                    help="supervisor wall-clock budget (s); on overrun "
                         "the last complete snapshot is emitted")
    ap.add_argument("--components", action="store_true",
                    help="also time the V-cycle's components one by one")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore / don't write the setup bundle cache")
    ap.add_argument("--cache-dir", type=str,
                    default=os.path.join(_REPO, ".bench_cache"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--direct", action="store_true",
                    help="run in-process without the supervisor "
                         "(no budget protection)")
    ap.add_argument("--status-file", type=str, default=None,
                    help=argparse.SUPPRESS)
    return ap


def main():
    args = build_parser().parse_args()

    if args.child or args.direct:
        payload = run_bench(args)
        if args.direct:
            print(json.dumps(payload))
        return 0

    # --- supervisor (never imports JAX: the child owns the device) ----
    fd, status = tempfile.mkstemp(prefix="bench_status_", suffix=".json")
    os.close(fd)
    os.unlink(status)
    cmd = ([sys.executable, os.path.abspath(__file__)]
           + sys.argv[1:] + ["--child", "--status-file", status])
    t_start = time.monotonic()
    # child stdout -> our stderr: the ONLY stdout line this process
    # prints is the final JSON
    child = subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr)
    rc = None
    budget_exceeded = False
    while True:
        rc = child.poll()
        if rc is not None:
            break
        if time.monotonic() - t_start > args.budget:
            budget_exceeded = True
            child.terminate()
            try:
                rc = child.wait(timeout=20)
            except subprocess.TimeoutExpired:
                child.kill()
                rc = child.wait()
            break
        time.sleep(1.0)

    payload = None
    if os.path.exists(status):
        try:
            with open(status) as f:
                payload = json.load(f)
            os.unlink(status)
        except Exception:
            payload = None
    if payload is None:
        payload = _skeleton("no_snapshot")
    payload.setdefault("extra", {})
    payload["extra"]["wall_s"] = round(time.monotonic() - t_start, 1)
    if budget_exceeded:
        payload["extra"]["budget_exceeded"] = True
        print(f"[bench] budget {args.budget:.0f}s exceeded; emitting "
              f"last snapshot (stage={payload['extra'].get('stage')})",
              file=sys.stderr)
    elif rc != 0:
        payload["extra"]["child_rc"] = rc
    sys.stderr.flush()
    print(json.dumps(payload))
    return 0 if rc == 0 or budget_exceeded else 1


if __name__ == "__main__":
    sys.exit(main())
