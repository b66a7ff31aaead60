"""Smoke test of the device path on one GPU: setup, Galerkin hierarchy
and V-cycle-preconditioned PCG through the entry points a user calls,
checked against the host float64 path and scipy.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --chips 4    # the sharded paths on four GPUs
    python chip_smoke.py --profile DIR  # + stencil backend timing/trace

Phases (one GPU):
  1. device check: fails unless JAX's default device is a GPU; prints
     the card's name and power limit from nvidia-smi;
  2. structured flagship: 3D Poisson on hex_mesh(96) (912,673 dofs),
     element coefficient 10**U(-2, 2) (seed 7), brick 8 with a
     superbrick third level, theta 0.003, nu_relax [3, 1], device setup;
     bf16 preconditioner storage, f32 PCG to 1e-6 and 1e-8; compared
     with the host float64 V-cycle + PCG on the same hierarchy;
  3. device setup against host setup at n=48: equal coarse dimensions;
  4. general path at n=48: k-way partition, 256 elements per AE, 3
     levels, compile_hierarchy + pcg_solve against the host path;
  5. every kept or translated kernel at the n=96 widths (27-diagonal
     stencil in flat and z-lane layout, f32 and bf16, tent R/P, mid
     brick-block matvec) against scipy CSR in float64.

Every phase is a function of its size, so tests run phases 2-5 on the
CPU at n=16.  The last line of standard output is one JSON object
naming the device; any failed check raises and exits non-zero.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _REPO)

import numpy as np

import jax
import jax.numpy as jnp

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.solve.pcg import pcg
from saamge_jax.utils.logging import TIMERS

# BASELINE.json parity rule: device PCG iterations within 10% of the
# host float64 path
ITER_SLACK = 1.1
# ||b - A x|| / ||b|| in float64.  An f32 solution vector cannot beat
# the residual of the exact solution rounded to f32, which grows like
# h^-2 (about 1e-6 at n=16 and 1e-5 at n=48 for this problem), so the
# bound is 1e-6 or FLOOR_SLACK times that floor, whichever is larger;
# the floor is taken from the host float64 solution rounded to f32
TRUE_RES_MAX = 1e-6
FLOOR_SLACK = 10.0
VCYCLE_F32_MAX = 1e-4    # all-f32 V-cycle vs host; TF32 would show ~1e-3
KERNEL_MAX = 1e-5        # per-kernel max abs error / max abs reference
# the stencil implementations the kernel phase compares; the production
# choice is ops.stencil.stencil_backend()
KERNEL_BACKENDS = ("xla", "triton")


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def rel_max(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


def device_summary():
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------------
# problems


def poisson(n, seed=7, contrast=2.0):
    """3D Poisson on hex_mesh(n), element coefficient 10**U(-c, c)."""
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(seed)
    coefs = 10.0 ** rng.uniform(-contrast, contrast, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    return mesh, ess, A, b, em


def structured_solver(n, brick=8, theta=0.003, device_setup=True,
                      levels=3):
    """The structured flagship setup (bench.py): brick partitioning with
    a superbrick third level.  Returns (solver, b, geo, supers)."""
    from saamge_jax.solve.structured import BrickGeometry
    from saamge_jax.topology.part import (partition_cartesian_3d,
                                          partition_cartesian_bricks)
    mesh, ess, A, b, em = poisson(n)
    nb = n // brick
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    sgrid = min((d for d in range(1, nb + 1) if nb % d == 0),
                key=lambda d: abs(d - nb / 4))
    supers = (sgrid,) * 3 if (levels >= 3 and sgrid > 1) else None
    override = (lambda i: partition_cartesian_bricks(
        (nb,) * 3, supers)) if supers else None
    opts = SolverOptions(num_levels=levels, correct_nulspace=False,
                         first_theta=theta, theta=theta, nu_relax=[3, 1],
                         device_setup=device_setup)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part, coarse_part_override=override)
    return s, b, BrickGeometry((nb,) * 3, (brick,) * 3), supers


def general_solver(n, theta=0.003, levels=3, elems_per_agg=256):
    """The general-path setup (bench.py): native k-way partitioning."""
    mesh, ess, A, b, em = poisson(n)
    opts = SolverOptions(num_levels=levels, correct_nulspace=False,
                         first_theta=theta, theta=theta,
                         first_elems_per_agg=elems_per_agg,
                         elems_per_agg=elems_per_agg, device_setup=False)
    return SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess), b


def host_pcg(s, b, rel_tol):
    """The host float64 path: the solver's V-cycle inside solve/pcg.py.
    Returns (iterations, solution)."""
    res = pcg(s.A, b, s.mult, rel_tol=rel_tol, max_iter=300)
    assert res.converged, f"host PCG did not converge at {rel_tol}"
    return res.iterations, res.x


def true_residual(A, b, x):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def check_pcg(A, b, dev_iters8, x8, host_iters8, x_host):
    bound = math.ceil(ITER_SLACK * host_iters8)
    check(dev_iters8 <= bound,
          f"PCG iterations at 1e-8: device {dev_iters8} <= "
          f"ceil({ITER_SLACK} x host {host_iters8}) = {bound}")
    floor = true_residual(A, b, np.asarray(x_host, np.float32))
    rr = true_residual(A, b, x8)
    lim = max(TRUE_RES_MAX, FLOOR_SLACK * floor)
    check(rr <= lim,
          f"true relative residual {rr:.3e} <= max({TRUE_RES_MAX:g}, "
          f"{FLOOR_SLACK:g} x f32 floor {floor:.3e}) = {lim:.3e}")
    return rr, floor


def memory_line(compiled):
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {f: getattr(ma, f, None) for f in fields} if ma else None


def peak_bytes():
    ms = jax.devices()[0].memory_stats() or {}
    return ms.get("peak_bytes_in_use")


# ---------------------------------------------------------------------
# phases


def phase_device():
    """1: the default device must be a GPU; print its name and power
    limit."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX's default device is "
                         f"{dev['platform']})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"card: {smi.stdout.strip()}")
    log(f"jax device: {dev}")
    return dev


def phase_structured(n):
    """2: structured flagship through SpectralAMGSolver,
    compile_structured and struct_pcg_solve, against the host path."""
    from saamge_jax.solve.structured import (compile_structured,
                                             struct_pcg_solve,
                                             struct_vcycle_apply)
    log(f"[phase 2] structured flagship, hex_mesh({n})")
    TIMERS.totals.clear()
    t0 = time.perf_counter()
    s, b, geo, supers = structured_solver(n)
    setup_s = time.perf_counter() - t0
    A = s.A
    log(f"  dofs {A.shape[0]}, levels "
        f"{[lv.A.shape[0] for lv in s.ml.levels]}, supers {supers}")
    log(f"  setup {setup_s:.2f} s; by phase (s): " + json.dumps(
        {k: round(v, 2) for k, v in sorted(TIMERS.totals.items())}))

    t0 = time.perf_counter()
    h = compile_structured(s.ml, geo, mid_dtype=jnp.bfloat16,
                           smoother_dtype=jnp.bfloat16,
                           rp_dtype=jnp.bfloat16, super_bricks=supers)
    build_s = time.perf_counter() - t0
    bdev = jnp.asarray(b, jnp.float32)
    t0 = time.perf_counter()
    vc = struct_vcycle_apply.lower(h, bdev).compile()
    vc_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x6, it6, _ = struct_pcg_solve(h, bdev, rel_tol=1e-6, max_iter=200)
    it6 = int(it6)
    pcg_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x8, it8, _ = struct_pcg_solve(h, bdev, rel_tol=1e-8, max_iter=200)
    it8 = int(it8)
    pcg8_s = time.perf_counter() - t0
    log(f"  hierarchy build {build_s:.2f} s, V-cycle compile "
        f"{vc_compile_s:.2f} s, PCG first call (compile + solve) "
        f"{pcg_first_s:.2f} s, PCG to 1e-8 {pcg8_s:.3f} s")
    log(f"  V-cycle memory_analysis: {json.dumps(memory_line(vc))}")
    log(f"  PCG iterations: {it6} at 1e-6, {it8} at 1e-8")

    host8, x_host = host_pcg(s, b, 1e-8)
    log(f"  host float64 PCG iterations at 1e-8: {host8}")
    rr, floor = check_pcg(A, b, it8, x8, host8, x_host)

    # all-f32 twin against the host V-cycle (a TF32 product shows ~1e-3)
    h32 = compile_structured(s.ml, geo, super_bricks=supers)
    y32 = struct_vcycle_apply(h32, bdev)
    d = rel_max(y32, s.mult(b))
    check(d <= VCYCLE_F32_MAX,
          f"f32 V-cycle vs host V-cycle rel diff {d:.2e} <= "
          f"{VCYCLE_F32_MAX:g}")
    log(f"  peak_bytes_in_use {peak_bytes()}")
    return {"solver": s, "b": b, "geo": geo, "supers": supers, "h32": h32,
            "h": h, "iters": (it6, it8), "host_iters8": host8,
            "true_res": rr, "f32_floor": floor, "vcycle_f32_diff": d}


def phase_setup_dims(n):
    """3: device setup and host setup give the same coarse dimensions
    on every level."""
    log(f"[phase 3] device vs host setup, hex_mesh({n})")
    dims = {}
    for dev in (True, False):
        s, _, _, _ = structured_solver(n, device_setup=dev)
        dims[dev] = [lv.A.shape[0] for lv in s.ml.levels] \
            + [s.ml.levels[-1].tg_data.Ac.shape[0]]
    check(dims[True] == dims[False],
          f"coarse dimensions device {dims[True]} == host {dims[False]}")
    return dims[True]


def phase_general(n):
    """4: the general path through compile_hierarchy and pcg_solve."""
    from saamge_jax.solve.compiled import (compile_hierarchy, pcg_solve,
                                           vcycle_apply)
    log(f"[phase 4] general path, hex_mesh({n})")
    s, b = general_solver(n)
    h = compile_hierarchy(s.ml, dtype=jnp.float32)
    log(f"  levels {[lv.A.shape[0] for lv in s.ml.levels]}, formats "
        f"{[type(lv.A).__name__ for lv in h.levels]}")
    bdev = jnp.asarray(b, jnp.float32)
    _, it6, _ = pcg_solve(h, bdev, rel_tol=1e-6, max_iter=300)
    x8, it8, _ = pcg_solve(h, bdev, rel_tol=1e-8, max_iter=300)
    it6, it8 = int(it6), int(it8)
    host8, x_host = host_pcg(s, b, 1e-8)
    log(f"  PCG iterations: {it6} at 1e-6, {it8} at 1e-8; host float64 "
        f"{host8} at 1e-8")
    rr, floor = check_pcg(s.A, b, it8, x8, host8, x_host)
    d = rel_max(vcycle_apply(h, bdev), s.mult(b))
    check(d <= VCYCLE_F32_MAX,
          f"V-cycle vs host V-cycle rel diff {d:.2e} <= "
          f"{VCYCLE_F32_MAX:g}")
    return {"iters": (it6, it8), "host_iters8": host8, "true_res": rr,
            "f32_floor": floor}


def _stencil_errors(A, dtype, backend, interpret=False):
    """Max relative error of spmv/residual/root of one StencilDIA
    configuration against scipy CSR in float64 (the bf16 twin against
    the operator rounded to bf16)."""
    from saamge_jax.ops.sparse import DeviceDIA
    from saamge_jax.ops.stencil import StencilDIA
    dia = DeviceDIA.try_from_csr(A, jnp.float32, max_diags=64)
    p = StencilDIA.from_dia(dia, dtype=dtype, backend=backend,
                            interpret=interpret)
    del dia
    Ar = A
    if dtype == jnp.bfloat16:
        Ar = A.copy()
        Ar.data = np.asarray(jnp.asarray(A.data, jnp.bfloat16), np.float64)
    n = A.shape[0]
    rng = np.random.default_rng(3)
    live = A.getnnz(axis=1) > 0          # z-lane padding rows are empty
    x, b, dv = (np.where(live, v, 0.0).astype(np.float32) for v in (
        rng.standard_normal(n), rng.standard_normal(n),
        rng.random(n) + 0.5))
    ax = Ar @ x.astype(np.float64)
    xh, bh, dh = (p.pad(jnp.asarray(v)) for v in (x, b, dv))
    out = {
        "spmv": rel_max(p.unpad(p.matvec_h(xh)), ax),
        "residual": rel_max(p.unpad(p.residual_h(bh, xh)), b - ax),
        "root": rel_max(
            p.unpad(p.root_h(jnp.asarray([0.7], jnp.float32), bh, dh, xh)),
            x + dv * (b - ax) * 0.7),
    }
    return out


def phase_kernels(n, ctx, interpret=False):
    """5: every kept or translated kernel at the widths of hex_mesh(n)
    against scipy CSR in float64.  ``ctx``: phase 2's result (its host
    hierarchy and all-f32 device twin); ``interpret`` runs the Pallas
    kernels in interpret mode (CPU tests)."""
    from saamge_jax.solve.structured import _zlane_csr, coarse_brick_numbering
    log(f"[phase 5] kernels at the hex_mesh({n}) widths")
    s, geo, h32 = ctx["solver"], ctx["geo"], ctx["h32"]
    A = s.ml.levels[0].A.tocsr()
    nzp = -(-geo.nodes[2] // 128) * 128
    layouts = {"flat": A, "zlane": _zlane_csr(A, geo.nodes, nzp)}
    results = {}
    for backend in KERNEL_BACKENDS:
        for lname, Al in layouts.items():
            for dname, dt in (("f32", jnp.float32),
                              ("bf16", jnp.bfloat16)):
                errs = _stencil_errors(Al, dt, backend, interpret)
                for mode, e in errs.items():
                    key = f"stencil.{backend}.{lname}.{dname}.{mode}"
                    results[key] = e
                    check(e <= KERNEL_MAX, f"{key} rel err {e:.2e}")
    # tent R/P (window extraction + slot-major contraction) and the mid
    # brick-block matvec, all-f32, against the host CSR operators
    tg0 = s.ml.levels[0].tg_data
    P = tg0.tent_interp.tocsr()
    cd_brick, slot, _, _ = coarse_brick_numbering(
        s.ml.levels[0].rels, tg0.interp_data.mis_numcoarsedof)
    flat_id = slot * geo.num_bricks + cd_brick
    rng = np.random.default_rng(4)
    r = rng.standard_normal(P.shape[0]).astype(np.float32)
    rc = np.asarray(h32.apply_R(jnp.asarray(r)))[flat_id]
    results["tent.R"] = rel_max(rc, P.T @ r.astype(np.float64))
    xc = rng.standard_normal(P.shape[1]).astype(np.float32)
    xcf = np.zeros(h32.n_flat, np.float32)
    xcf[flat_id] = xc
    results["tent.P"] = rel_max(h32.apply_P(jnp.asarray(xcf)),
                                P @ xc.astype(np.float64))
    if h32.A1d is not None:
        Ac = tg0.Ac.tocsr()
        ym = np.asarray(h32._mid_matvec(jnp.asarray(xcf)))[flat_id]
        results["mid.matvec"] = rel_max(ym, Ac @ xc.astype(np.float64))
    for key in ("tent.R", "tent.P", "mid.matvec"):
        if key in results:
            check(results[key] <= KERNEL_MAX,
                  f"{key} rel err {results[key]:.2e}")
    return results


# ---------------------------------------------------------------------
# optional: stencil backend timing and a profiler trace of the V-cycle


def profile_vcycle(ctx, out_dir, reps=50):
    """Times the n=96 V-cycle with each stencil backend, in turns
    (xla, triton, triton, xla), and writes one profiler trace per
    backend under ``out_dir``; prints the device time share of the
    largest ops."""
    from saamge_jax.solve.structured import compile_structured
    s, geo, supers, b = ctx["solver"], ctx["geo"], ctx["supers"], ctx["b"]
    bdev = jnp.asarray(b, jnp.float32)
    hs = {be: compile_structured(s.ml, geo, mid_dtype=jnp.bfloat16,
                                 smoother_dtype=jnp.bfloat16,
                                 rp_dtype=jnp.bfloat16,
                                 super_bricks=supers, backend=be)
          for be in ("xla", "triton")}

    @jax.jit
    def chain(hier, b0):
        def body(c, _):
            return hier.vcycle(b0, c), ()
        y, _ = jax.lax.scan(body, jnp.zeros_like(b0), jnp.zeros(reps))
        return jnp.sum(y)

    for be, hh in hs.items():
        float(chain(hh, bdev))                 # compile + warm
    times = {be: [] for be in hs}
    for be in ("xla", "triton", "triton", "xla"):
        t0 = time.perf_counter()
        float(chain(hs[be], bdev * 1.000001))
        times[be].append((time.perf_counter() - t0) / reps * 1e3)
    log(f"  V-cycle ms by stencil backend (turns x,t,t,x): "
        f"{json.dumps(times)}")
    os.makedirs(out_dir, exist_ok=True)
    shares = {}
    for be, hh in hs.items():
        tdir = os.path.join(out_dir, f"trace_{be}")
        with jax.profiler.trace(tdir):
            float(chain(hh, bdev))
        shares[be] = trace_op_shares(tdir)
        log(f"  trace {be}: top ops by device time: "
            f"{json.dumps(shares[be][:12])}")
    with open(os.path.join(out_dir, "vcycle_profile.json"), "w") as f:
        json.dump({"vcycle_ms": times, "op_shares": shares,
                   "reps": reps}, f, indent=1)
    return times, shares


def trace_op_shares(trace_dir):
    """Device op time shares of one profiler trace: sums event durations
    by name over the GPU planes; [(name, ms, share)] largest first."""
    import glob
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    pd = jax.profiler.ProfileData.from_file(max(paths,
                                                key=os.path.getmtime))
    tot = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
    total = sum(tot.values()) or 1.0
    return [(k, round(v / 1e6, 3), round(v / total, 4))
            for k, v in sorted(tot.items(), key=lambda kv: -kv[1])]


# ---------------------------------------------------------------------
# four devices


def _one_shard_per_device(arrays, devices):
    """Every sharded array has exactly one addressable shard on each of
    the mesh devices."""
    want = set(devices)
    for a in arrays:
        if a is None:
            continue
        got = [sh.device for sh in a.addressable_shards]
        if len(got) != len(want) or set(got) != want:
            return False
    return True


def phase_sharded_general(n, mesh):
    from saamge_jax.parallel.sharded import (make_sharded_pcg_jit,
                                             shard_hierarchy, shard_vector)
    from saamge_jax.solve.compiled import compile_hierarchy, pcg_solve
    log(f"[4 devices] sharded general PCG, hex_mesh({n})")
    s, b = general_solver(n)
    _, it1, _ = pcg_solve(compile_hierarchy(s.ml), jnp.asarray(b,
                                                               jnp.float32),
                          rel_tol=1e-6, max_iter=300)
    h = shard_hierarchy(s.ml, mesh, dtype=jnp.float32)
    bsh = shard_vector(h, b)
    _, it = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=300)(bsh)
    check(int(it) == int(it1), f"sharded PCG iterations {int(it)} == "
          f"single-device {int(it1)}")
    check(_one_shard_per_device([bsh], mesh.devices.flat),
          "sharded general vector: one shard per device")
    return int(it), int(it1)


def phase_sharded_structured(n, mesh):
    from saamge_jax.parallel.structured_sharded import (
        gather_fine, make_struct_sharded_pcg, make_struct_sharded_vcycle,
        scatter_fine, shard_structured)
    from saamge_jax.setup.device_rap import sharded_structured_rap
    from saamge_jax.solve.structured import (compile_structured,
                                             struct_pcg_solve,
                                             struct_vcycle_apply)
    log(f"[4 devices] structured x-slab, hex_mesh({n})")
    s, b, geo, supers = structured_solver(n)
    ndev = mesh.devices.size
    check(geo.bricks[0] % ndev == 0,
          f"{geo.bricks[0]} bricks per side split over {ndev} devices")
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           super_bricks=supers)
    bdev = jnp.asarray(b, jnp.float32)
    y_ref = np.asarray(struct_vcycle_apply(h, bdev))
    _, it_ref, _ = struct_pcg_solve(h, bdev, max_iter=200)
    hs = shard_structured(h, mesh)
    bsh = scatter_fine(hs, b)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bsh))
    d = rel_max(y, y_ref)
    check(d <= 1e-5, f"sharded V-cycle vs single-device rel diff "
          f"{d:.2e} <= 1e-05")
    _, it = make_struct_sharded_pcg(hs, max_iter=200)(bsh)
    check(int(it) == int(it_ref), f"sharded structured PCG iterations "
          f"{int(it)} == single-device {int(it_ref)}")
    sharded = [hs.vals0, hs.dinv0, hs.rst, hs.blocks1, hs.dinv1, hs.r1,
               hs.vals0s, hs.rst1, bsh]
    check(_one_shard_per_device(sharded, mesh.devices.flat),
          "structured shards: one addressable shard per device")

    tg0 = s.ml.levels[0].tg_data
    Ac_host = tg0.Ac.tocsr()
    Ac_sh = sharded_structured_rap(
        s.ml.levels[0].A.tocsr(), s.ml.levels[0].rels,
        tg0.tent_interp.tocsr(), tg0.interp_data.mis_numcoarsedof, geo,
        mesh)
    rap = abs(Ac_sh - Ac_host).max() / abs(Ac_host).max()
    check(rap <= 1e-5, f"sharded_structured_rap vs host Ac rel diff "
          f"{rap:.2e} <= 1e-05")
    return {"vcycle_diff": d, "iters": int(it), "iters_ref": int(it_ref),
            "rap_diff": float(rap)}


def phase_dist_setup(mesh):
    """Distributed (mesh-sharded eigensolves) and SPMD rank-decomposed
    setup reproduce the single-host coarse spaces."""
    from saamge_jax.api import bdr_dof_flags
    from saamge_jax.parallel.spmd_setup import (spmd_coarsen,
                                                spmd_ml_produce_data)
    from saamge_jax.setup.ml import MultilevelParameters
    from saamge_jax.solve.vcycle import VCycleSolver
    from saamge_jax.topology.part import partition_cartesian_3d
    ndev = mesh.devices.size
    log("[4 devices] distributed and SPMD setup")
    m2 = hex_mesh(8)
    ess2 = np.ones(m2.max_bdr_attr(), dtype=np.int64)
    A2, b2, em2, _, _ = assemble.build_discrete_problem(
        m2, coef=1.0, rhs=1.0, ess_attr_marker=ess2)
    part2 = partition_cartesian_3d(m2.elem_centers(), 2, 2, 2)
    dims = []
    for sm in (None, mesh):
        s2 = SpectralAMGSolver(
            A2, m2, em2,
            SolverOptions(num_levels=2, correct_nulspace=False),
            ess_attr_marker=ess2, partitioning=part2.copy(),
            setup_mesh=sm)
        dims.append(s2.ml.levels[0].tg_data.Ac.shape[0])
    check(dims[0] == dims[1], f"distributed setup coarse dim {dims[1]} "
          f"== single-host {dims[0]}")
    sp_out = spmd_coarsen(m2.elem_to_dof(1, 1), m2.elem_to_elem(), em2,
                          bdr_dof_flags(m2, ess2), ndev,
                          partitioning=part2.copy(), theta=0.003,
                          use_truncated=False, setup_mesh=mesh)
    check(sp_out.P.shape[1] == dims[0], f"SPMD coarsen coarse dim "
          f"{sp_out.P.shape[1]} == {dims[0]}")
    rap_ref = (sp_out.P.T @ A2 @ sp_out.P).tocsr()
    check(abs(sp_out.Ac - rap_ref).max() <= 1e-10 * abs(rap_ref).max(),
          "SPMD distributed RAP == controller Galerkin product")

    mS = hex_mesh(12)
    essS = np.ones(mS.max_bdr_attr(), dtype=np.int64)
    AS, bS, emS, _, _ = assemble.build_discrete_problem(
        mS, coef=1.0, rhs=1.0, ess_attr_marker=essS)
    npartsS = max(1, mS.num_elements // 64)
    mlS, _ = spmd_ml_produce_data(
        mS.elem_to_dof(1, 1), mS.elem_to_elem(), emS,
        bdr_dof_flags(mS, essS), ndev,
        MultilevelParameters(num_coarsenings=1, nparts_arr=[npartsS],
                             use_correct_nullspace=False),
        A=AS, elems_per_agg=64, setup_mesh=mesh)
    vsS = VCycleSolver(mlS.finest.tg_data)
    vsS.set_operator(mlS.finest.A)

    def prec(r):
        z = np.zeros_like(r)
        vsS.mult(r, z)
        return z

    itS = pcg(AS, bS, prec, rel_tol=1e-6, max_iter=60).iterations
    sS = SpectralAMGSolver(
        AS, mS, emS,
        SolverOptions(num_levels=2, correct_nulspace=False,
                      first_elems_per_agg=64, elems_per_agg=64),
        ess_attr_marker=essS)
    it1 = sS.solve(bS).iterations
    check(itS == it1, f"SPMD setup PCG iterations {itS} == single-host "
          f"{it1}")
    return dims


def run_four(n_general, n_structured, devices):
    from jax.sharding import Mesh
    mesh = Mesh(np.array(devices[:4]), ("dp",))
    phase_sharded_general(n_general, mesh)
    phase_sharded_structured(n_structured, mesh)
    phase_dist_setup(mesh)


# ---------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths, on 4 GPUs")
    ap.add_argument("--n", type=int, default=96,
                    help="structured flagship size")
    ap.add_argument("--n-small", type=int, default=48,
                    help="size of the setup-dims and general phases")
    ap.add_argument("--profile", type=str, default=None,
                    help="also time the V-cycle per stencil backend and "
                         "write profiler traces to this directory")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    dev = phase_device()
    if args.chips == 4:
        if dev["count"] < 4:
            raise SystemExit(f"chip_smoke: --chips 4 needs 4 GPUs, "
                             f"found {dev['count']}")
        run_four(args.n_small, args.n, jax.devices())
        dev = dict(dev, count=4)
    else:
        ctx = phase_structured(args.n)
        phase_setup_dims(args.n_small)
        phase_general(args.n_small)
        phase_kernels(args.n, ctx)
        if args.profile:
            profile_vcycle(ctx, args.profile)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
