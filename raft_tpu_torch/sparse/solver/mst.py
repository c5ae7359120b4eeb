"""Minimum spanning tree by Borůvka on the host (counterpart of
``raft_tpu.sparse.solver.mst``, its numpy route; the JAX package's
native C++ route is not ported).

Weights are altered by an edge-unique epsilon below the smallest weight
gap (the reference's ``altered_weights``), so the minimum spanning
forest is unique. Each round takes every component's cheapest outgoing
edge and merges along them in component order; a merged component is
labelled by its lowest vertex, as the JAX package's relabel does. The
port keeps that order and labelling with a union-find (the relabel is
O(n) a merge there), so both return the same edges in the same order
and the same component labels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _alter_weights(w: np.ndarray, src: np.ndarray, dst: np.ndarray
                   ) -> np.ndarray:
    """Weights plus an edge-unique epsilon below the smallest gap."""
    if len(w) == 0:
        return w.astype(np.float64)
    uniq = np.unique(w)
    gap = np.min(np.diff(uniq)) if len(uniq) > 1 else 1.0
    lo = np.minimum(src, dst).astype(np.float64)
    hi = np.maximum(src, dst).astype(np.float64)
    n = max(int(hi.max()) + 1, 1)
    eps = gap / (2.0 * (n * n + 1.0))
    return w.astype(np.float64) + eps * (lo * n + hi)


def _cheapest_out(cs: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Per component in ascending order, the position of its cheapest
    edge (the first at a tie): ``lexsort((w, cs))``'s first of each
    component."""
    best = np.full(int(cs.max()) + 1, np.inf)
    np.minimum.at(best, cs, w)
    at_min = np.flatnonzero(w == best[cs])
    _, first = np.unique(cs[at_min], return_index=True)
    return at_min[first]


def boruvka_mst_edges(n: int, src, dst, weight
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Borůvka over an undirected edge list → (mst_src, mst_dst,
    mst_weight, component_labels). A disconnected graph gives a minimum
    spanning forest, its components labelled by their lowest vertex."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w_orig = np.asarray(weight, np.float64)
    aw = _alter_weights(w_orig, src, dst)

    parent = np.arange(n, dtype=np.int64)   # union-find, root = lowest

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    def labels():
        comp = parent.copy()
        while True:
            nxt = comp[comp]
            if np.array_equal(nxt, comp):
                return comp
            comp = nxt

    # both directions of every edge, for the per-component search
    es, ed = np.concatenate([src, dst]), np.concatenate([dst, src])
    ew = np.concatenate([aw, aw])
    eorig = np.concatenate([w_orig, w_orig])
    out_s, out_d, out_w = [], [], []
    comp = labels()
    while True:
        cs, cd = comp[es], comp[ed]
        cross = np.flatnonzero(cs != cd)
        if len(cross) == 0:
            break
        merged_any = False
        for e in cross[_cheapest_out(cs[cross], ew[cross])]:
            a, b = find(es[e]), find(ed[e])
            if a == b:
                continue
            lo, hi = (a, b) if a < b else (b, a)
            parent[hi] = lo
            out_s.append(es[e])
            out_d.append(ed[e])
            out_w.append(eorig[e])
            merged_any = True
        if not merged_any:
            break
        comp = labels()
    return (np.asarray(out_s, np.int64), np.asarray(out_d, np.int64),
            np.asarray(out_w, np.float64), comp)


def mst(n: int, src, dst, weight, res=None):
    """The MST (or spanning forest) of an edge list → (src, dst,
    weight)."""
    s, d, w, _ = boruvka_mst_edges(n, src, dst, weight)
    return s, d, w
