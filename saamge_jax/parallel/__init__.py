"""Multi-chip distribution: sharded hierarchies and halo kernels."""

from saamge_jax.parallel.sharded import (ShardedHierarchy, make_sharded_pcg,
                                         make_sharded_pcg_jit,
                                         make_sharded_vcycle,
                                         shard_hierarchy)
from saamge_jax.parallel.halo import (HaloDIA, halo_smoother_fn,
                                      halo_spmv_fn)
from saamge_jax.parallel.spmd_setup import (SPMDSetup, spmd_coarsen,
                                            spmd_ml_produce_data)

__all__ = [
    "ShardedHierarchy", "shard_hierarchy", "make_sharded_vcycle",
    "make_sharded_pcg", "make_sharded_pcg_jit", "HaloDIA",
    "halo_spmv_fn", "halo_smoother_fn",
    "SPMDSetup", "spmd_coarsen", "spmd_ml_produce_data",
]
