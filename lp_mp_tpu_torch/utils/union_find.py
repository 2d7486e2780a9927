"""Path-compressed union-find (reference union_find.hxx; copy of
``lp_mp_tpu/utils/union_find.py``, NumPy only)."""
from __future__ import annotations

import numpy as np


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int64)

    def find(self, i: int) -> int:
        root = i
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def merge(self, i: int, j: int) -> bool:
        ri, rj = self.find(i), self.find(j)
        if ri == rj:
            return False
        if self.rank[ri] < self.rank[rj]:
            ri, rj = rj, ri
        self.parent[rj] = ri
        if self.rank[ri] == self.rank[rj]:
            self.rank[ri] += 1
        return True

    def connected(self, i: int, j: int) -> bool:
        return self.find(i) == self.find(j)

    def get_contiguous_ids(self) -> np.ndarray:
        """Component id in [0, #components) per element (union_find.hxx:
        get_contiguous_ids)."""
        roots = np.array([self.find(i) for i in range(len(self.parent))])
        _, ids = np.unique(roots, return_inverse=True)
        return ids
