"""Device operator formats and batched setup kernels."""

from saamge_jax.ops.sparse import (DeviceBanded, DeviceDIA, DeviceELL,
                                   device_matrix, rcm_permutation)
from saamge_jax.ops.blockrow import DeviceBlockRow, TransposedBlockRow
from saamge_jax.ops.batched_eig import batched_spectral_cut

__all__ = [
    "DeviceBanded", "DeviceDIA", "DeviceELL",
    "DeviceBlockRow", "TransposedBlockRow", "device_matrix",
    "rcm_permutation", "batched_spectral_cut",
]
