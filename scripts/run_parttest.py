"""Driver mirroring `parttest` (test/parttest/parttest.cpp): partition a
10-node weighted ring graph and print the assignment."""

import sys

import numpy as np

sys.path.insert(0, ".")

from saamge_jax.topology.part import partition_kway
from saamge_jax.utils.tables import Table


def main():
    n = 10
    rows = [np.array([(i - 1) % n, (i + 1) % n]) for i in range(n)]
    ring = Table.from_rows(rows, n)
    weights = np.ones(n)
    weights[0] = 5.0                      # one heavy vertex, like parttest
    for nparts in (2, 3, 4):
        part = partition_kway(ring, weights, nparts)
        sizes = np.bincount(part, weights=weights)
        print(f"nparts={nparts}: {part.tolist()} weighted sizes "
              f"{sizes.tolist()}")


if __name__ == "__main__":
    main()
