"""Multi-chip sharded solve demo (BASELINE.json config 5: 3D anisotropic
diffusion distributed over a device mesh).

Runs end-to-end on real chips when available, otherwise on a virtual CPU
mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N), and checks the
device-count-invariance of the PCG iteration count (the reference's
pmltest contract).
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--eps", type=float, default=1e-2,
                    help="anisotropy ratio")
    args = ap.parse_args()

    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
                    f"{args.devices}").strip()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from saamge_jax.api import SpectralAMGSolver
    from saamge_jax.config import SolverOptions
    from saamge_jax.fem import assemble
    from saamge_jax.fem.coefficients import anisotropic_tensor
    from saamge_jax.fem.mesh import hex_mesh
    from saamge_jax.parallel.sharded import (make_sharded_pcg_jit,
                                             shard_hierarchy,
                                             shard_vector, unshard_vector)

    devs = jax.devices()
    if len(devs) < args.devices:
        devs = jax.devices("cpu")
    mesh_dev = Mesh(np.array(devs[:args.devices]), axis_names=("dp",))

    mesh = hex_mesh(args.n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coef = anisotropic_tensor(np.array([1.0, 0.0, 0.0]), eps=args.eps)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    s = SpectralAMGSolver(
        A, mesh, em,
        SolverOptions(num_levels=2, correct_nulspace=False,
                      first_elems_per_agg=64),
        ess_attr_marker=ess)
    res_host = s.solve(b)
    print(f"host PCG iterations: {res_host.iterations}")

    h = shard_hierarchy(s.ml, mesh_dev, dtype=jnp.float64)
    solve = make_sharded_pcg_jit(h, rel_tol=1e-6, max_iter=200)
    # shard/unshard apply the band renumbering + padding (the raw
    # padded layout is RCM-permuted — slicing it directly scrambles x)
    x, iters = solve(shard_vector(h, b))
    x = unshard_vector(h, x)
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    print(f"{mesh_dev.devices.size}-device PCG iterations: {int(iters)}, "
          f"rel res {rel:.2e}")
    assert int(iters) == res_host.iterations, "device-count invariance!"
    print("device-count invariance holds.")


if __name__ == "__main__":
    main()
