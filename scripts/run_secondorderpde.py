#!/usr/bin/env python
"""Second-order PDE driver: -div((b b^T + eps I) grad u) + k^2 u = 1.

Mirrors the reference's secondorderpdetest (geometric SAAMGePC,
secondorderpdetest.cpp:87-224) and secondorderpdealgebraictest
(--algebraic: matrix-only SAAMGeAlgPC on the assembled operator,
secondorderpdealgebraictest.cpp).  The anisotropy direction prefers x or
y with magnitudes 0..10*(dim-1) (make_b_local, secondorderpdetest.cpp:58)
and the diffusion tensor is b b^T + 0.001 I
(AnisotropicDiffusionIntegrator.cpp:131-149)."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

from saamge_jax.api import SAAMGeAlgPC, SpectralAMGSolver  # noqa: E402
from saamge_jax.config import SolverOptions  # noqa: E402
from saamge_jax.fem import assemble  # noqa: E402
from saamge_jax.fem.coefficients import anisotropic_tensor  # noqa: E402
from saamge_jax.fem.mesh import read_mesh  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--mesh",
                    default="/root/reference/amg/test/mltest.mesh")
    ap.add_argument("-na", "--no-aniso", action="store_true",
                    help="isotropic diffusion instead")
    ap.add_argument("-y", "--y-prefer", action="store_true",
                    help="preferential direction y instead of x")
    ap.add_argument("-k", "--k", type=float, default=200.0,
                    help="k^2 in div(grad(u)) + k^2 u")
    ap.add_argument("--algebraic", action="store_true",
                    help="matrix-only SAAMGeAlgPC path "
                         "(secondorderpdealgebraictest)")
    ap.add_argument("--target-ne", type=int, default=10000)
    ap.add_argument("--theta", type=float, default=0.003)
    args = ap.parse_args()

    mesh = read_mesh(args.mesh)
    # refine toward ~target elements, then once more
    # (secondorderpdetest.cpp:121-131)
    mesh = mesh.refined_to_at_least(args.target_ne).refine_uniform()
    dim = mesh.dim

    # b vector: entries i*10, reversed for x-preference (make_b_local)
    b_vec = np.ones(dim)
    for i in range(dim):
        if args.y_prefer:
            b_vec[i] = i * 10
        else:
            b_vec[dim - 1 - i] = i * 10

    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    if args.no_aniso:
        em = assemble.diffusion_element_matrices(mesh, 1.0)
    else:
        em = assemble.diffusion_element_matrices(
            mesh, anisotropic_tensor(b_vec), matrix_coef=True)
    # + k^2 mass term (MassIntegrator, secondorderpdetest.cpp:165), then
    # one combined essential-BC elimination like the reference's single
    # EliminateEssentialBC call (secondorderpdetest.cpp:175)
    em = np.asarray(em) + assemble.mass_element_matrices(mesh, args.k)
    e2d = mesh.elem_to_dof()
    A = assemble.assemble_global(em, e2d, mesh.num_dofs())
    b = assemble.domain_lf(mesh, 1.0)
    essd = assemble.ess_dofs_from_attrs(mesh, ess)
    x0 = np.zeros_like(b)
    A = assemble.eliminate_essential_bc(A, essd, x0, b, keep_diag=True)
    print(f"Number of finite element unknowns: {A.shape[0]}")

    if args.algebraic:
        pc = SAAMGeAlgPC(A, SolverOptions(theta=args.theta,
                                          correct_nulspace=False),
                         eliminate_dof0=False)
        res = pc.solve(b)
    else:
        opts = SolverOptions(num_levels=2, theta=args.theta,
                             correct_nulspace=False)
        s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
        res = s.solve(b)
    print(f"iterations: {res.iterations} converged: {res.converged}")
    return 0 if res.converged else 1


if __name__ == "__main__":
    sys.exit(main())
