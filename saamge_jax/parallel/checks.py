"""Shared flagship-configuration sharded parity check.

The flagship configuration (full-bf16 twins + superbrick coarsest)
sharded over a device mesh must reproduce the single-device
preconditioner: PCG iteration equality (the pmltest
serial/parallel-equivalence invariant, reference
amg/CMakeLists.txt:198-203) and V-cycle agreement.

One implementation, two callers: the dryrun
(`__graft_entry__.dryrun_multichip`) runs it at n=48 and
`tests/test_struct_sharded.py` keeps it as a suite regression at a
smaller size.
"""

from __future__ import annotations

import numpy as np


def production_regime_sharded_check(mesh, ns: int = 48, brick: int = 6,
                                    supers=(2, 2, 2), seed: int = 7,
                                    max_iter: int = 80) -> dict:
    """Build a high-contrast 3-level hierarchy at (ns+1)^3 dofs, compile
    the flagship configuration, shard it, and assert parity and the
    O(N1/P) mid storage.  Returns diagnostics for the caller's report."""
    import jax.numpy as jnp

    from saamge_jax.api import SpectralAMGSolver
    from saamge_jax.config import SolverOptions
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import hex_mesh
    from saamge_jax.parallel.structured_sharded import (
        gather_fine, make_struct_sharded_pcg, make_struct_sharded_vcycle,
        mid_bytes_per_device, scatter_fine, shard_structured)
    from saamge_jax.solve.structured import (BrickGeometry,
                                             compile_structured,
                                             struct_pcg_solve)
    from saamge_jax.topology.part import (partition_cartesian_3d,
                                          partition_cartesian_bricks)

    n_devices = mesh.devices.size
    nb = ns // brick
    assert ns % brick == 0
    assert nb % n_devices == 0, (nb, n_devices)   # shard_structured's x-slabs
    m = hex_mesh(ns)
    ess = np.ones(m.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(seed)
    coef = 10.0 ** rng.uniform(-2.0, 2.0, m.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        m, coef=coef, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(m.elem_centers(), nb, nb, nb)
    s = SpectralAMGSolver(
        A, m, em,
        SolverOptions(num_levels=3, correct_nulspace=False,
                      first_theta=1e-4, theta=1e-4, nu_relax=[3, 1]),
        ess_attr_marker=ess, partitioning=part,
        coarse_part_override=lambda i: partition_cartesian_bricks(
            (nb,) * 3, supers))
    geo = BrickGeometry((nb,) * 3, (brick,) * 3)
    h = compile_structured(s.ml, geo, fine_layout="zlane",
                           mid_dtype=jnp.bfloat16,
                           smoother_dtype=jnp.bfloat16,
                           rp_dtype=jnp.bfloat16, super_bricks=supers)
    bdev = jnp.asarray(b, jnp.float32)
    y_ref = np.asarray(h.vcycle(bdev, jnp.zeros_like(bdev)))
    _, it_ref, _ = struct_pcg_solve(h, bdev, max_iter=max_iter)
    hs = shard_structured(h, mesh)
    # the flagship config must shard with O(N1/P) per-device mid
    # storage — blocks, dinv1 and the superbrick coarsest restriction
    # all sharded; the only replicated coarse objects are the small
    # coarsest solve (Ainv) and index map
    assert hs.rst1 is not None, "superbrick coarsest must shard"
    acct = mid_bytes_per_device(hs)
    total_mid = (h.A1d.nbytes
                 + h.dinv1.size * h.dinv1.dtype.itemsize
                 + h.Rst1.size * h.Rst1.dtype.itemsize)
    assert acct["sharded"] <= total_mid // n_devices + (total_mid // 8), \
        (acct, total_mid)
    assert acct["replicated"] <= (h.Ainv.size * h.Ainv.dtype.itemsize
                                  + (1 << 20)), acct
    bsh = scatter_fine(hs, b)
    y = gather_fine(hs, make_struct_sharded_vcycle(hs)(bsh))
    # same per-element arithmetic; the bf16 twins round x to bf16 each
    # pass, so a last-bit f32 difference can flip one rounding
    vc_diff = np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-30)
    assert vc_diff <= 1e-4, vc_diff
    x, it = make_struct_sharded_pcg(hs, max_iter=max_iter)(bsh)
    assert int(it) == int(it_ref), (int(it), int(it_ref))
    xh = gather_fine(hs, x)
    rel = np.linalg.norm(b - A @ xh) / np.linalg.norm(b)
    assert rel < 1e-4, rel
    return {"n": A.shape[0], "vc_diff": vc_diff, "iters": int(it),
            "iters_ref": int(it_ref), "rel_res": rel,
            "mid_bytes": acct, "mid_bytes_total": total_mid}
