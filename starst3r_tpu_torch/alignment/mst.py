"""Maximum-score spanning tree over the pairwise-score matrix.

Behavioral spec (SURVEY §2b "MST pose initialization" row; call-site
reference starster/reconstruct.py:104): the tree's root becomes the world
frame and its edges form the kinematic pose chain
(reference reconstruct.py:232-238). Camera counts are small, so this is
host-side numpy (Prim), as §7.2 layer 5 prescribes; the chain *composition*
happens on device in ga.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ("max_spanning_tree",)


def max_spanning_tree(scores: np.ndarray) -> Tuple[int, List[Tuple[int, int]]]:
    """Prim's algorithm maximizing total edge score.

    scores: (N, N) symmetric-ish pairwise score matrix (only the max of
    scores[i, j], scores[j, i] is used). Returns (root, edges) where edges
    are (parent, child) in the order added — already topologically sorted
    (every child appears after its parent), ready for sequential chain
    composition.
    """
    s = np.asarray(scores, dtype=np.float64)
    n = s.shape[0]
    assert s.shape == (n, n)
    if n == 1:
        return 0, []
    sym = np.maximum(s, s.T)
    np.fill_diagonal(sym, -np.inf)

    # root: endpoint of the globally best edge (ties broken by index)
    root = int(np.unravel_index(np.argmax(sym), sym.shape)[0])

    in_tree = np.zeros(n, dtype=bool)
    in_tree[root] = True
    best_score = sym[root].copy()
    best_parent = np.full(n, root)
    edges: List[Tuple[int, int]] = []
    for _ in range(n - 1):
        cand = np.where(in_tree, -np.inf, best_score)
        j = int(np.argmax(cand))
        if not np.isfinite(cand[j]):
            # disconnected graph: attach remaining node to root with -inf
            # score (still produces a valid chain)
            pass
        edges.append((int(best_parent[j]), j))
        in_tree[j] = True
        improve = sym[j] > best_score
        best_score = np.where(improve, sym[j], best_score)
        best_parent = np.where(improve, j, best_parent)
    return root, edges
