"""saamge_jax: a spectral element-based algebraic multigrid (AMGe) framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of LLNL/saamge:
element agglomeration over a partitioned dual graph, per-agglomerate
generalized eigenproblems defining coarse spaces, SVD-based tentative
prolongators over minimal intersection sets (MISes), smoothed-aggregation
prolongator smoothing, Galerkin (RAP) coarse operators built recursively
into a multilevel hierarchy, polynomial (SAS/Chebyshev) relaxation, and
V-cycle solvers used stand-alone or as PCG preconditioners.

Architecture (accelerator-first, not a port):
  - Topology (partitioning, relation tables, MIS discovery) runs once per level
    on host (numpy/scipy), producing static index arrays.
  - Setup numerics (batched AE eigensolves, MIS SVDs, RAP) run either on host
    in float64 (parity path) or as batched padded dense ops on device.
  - The solve phase (V-cycle + PCG) is a single jitted JAX computation over a
    static hierarchy: DIA/banded/ELL SpMV, polynomial smoothers, psum dot products,
    dense Cholesky coarsest solve; sharded over a jax.sharding.Mesh for
    multi-device runs (replacing the reference's hypre ParCSR + MPI).
"""

import os as _os

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _enable_persistent_compile_cache() -> None:
    """Persistent XLA compile cache: the batched setup eigensolves and the
    solve programs compile for seconds to minutes, cached loads take
    milliseconds.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at the fixed path
    ``<repo>/.jax_cache`` (the path is part of the cache key, so it must
    not move between runs).  Opt out with SAAMGE_NO_COMPILE_CACHE=1.

    NEVER enabled for the CPU backend: a cached XLA:CPU AOT executable
    embeds the compile machine's CPU features and the cache key does
    NOT (jax logs "machine type ... doesn't match" and loading has been
    observed to SEGFAULT the process mid-testsuite).  Callers that pin
    the CPU platform after import (tests/conftest, dryrun_multichip)
    must also call disable_compile_cache()."""
    if _os.environ.get("SAAMGE_NO_COMPILE_CACHE"):
        return
    if _os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir",
                      _os.path.join(_REPO_ROOT, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def disable_compile_cache() -> None:
    """Turn the persistent compile cache off for this process (REQUIRED
    after pinning the CPU platform — see _enable_persistent_compile_cache)."""
    import jax
    jax.config.update("jax_compilation_cache_dir", None)


_enable_persistent_compile_cache()

from saamge_jax.config import GlobalConfig, TGConfig, CONFIG
from saamge_jax.fem.mesh import Mesh
from saamge_jax.api import SpectralAMGSolver, SAAMGePC, SAAMGeAlgPC


def structured_solver_api():
    """Late imports of the structured (brick) fast path, the production
    device solve configuration: (BrickGeometry, compile_structured,
    struct_pcg_solve, struct_vcycle_apply, partition_cartesian_3d)."""
    from saamge_jax.solve.structured import (BrickGeometry,
                                             compile_structured,
                                             struct_pcg_solve,
                                             struct_vcycle_apply)
    from saamge_jax.topology.part import partition_cartesian_3d
    return (BrickGeometry, compile_structured, struct_pcg_solve,
            struct_vcycle_apply, partition_cartesian_3d)

__version__ = "0.1.0"

__all__ = [
    "GlobalConfig",
    "TGConfig",
    "CONFIG",
    "Mesh",
    "SpectralAMGSolver",
    "SAAMGePC",
    "SAAMGeAlgPC",
]
