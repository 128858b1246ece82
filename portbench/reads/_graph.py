"""The plain reference of the LDBC reads: the graph's adjacency worked
out again from the generated edge list, and breadth-first steps over it
in numpy. Imports nothing of the port."""

from __future__ import annotations

import numpy as np


class Adjacency:
    """Both directions of every undirected edge, as (source, target)
    index arrays; `edges` may be a prefix of the data's (a stale
    snapshot, for the control)."""

    def __init__(self, n: int, edges: np.ndarray):
        self.n = n
        self.src = np.concatenate([edges[:, 0], edges[:, 1]])
        self.dst = np.concatenate([edges[:, 1], edges[:, 0]])

    def step(self, frontier: np.ndarray) -> np.ndarray:
        """The persons that some person in the boolean `frontier` knows."""
        out = np.zeros(self.n, bool)
        out[self.dst[frontier[self.src]]] = True
        return out

    def onehot(self, i: int) -> np.ndarray:
        f = np.zeros(self.n, bool)
        f[i] = True
        return f


def adjacency(data, stale_share: float = 0.0) -> Adjacency:
    m = len(data.edges)
    keep = m - int(round(stale_share * m))
    return Adjacency(len(data.ids), data.edges[:keep])


def start_index(data, sid: int) -> int:
    return int((sid - 933) // 7)


BLOCK = 32


def strata(rng, count: int, block: int = BLOCK) -> np.ndarray:
    """`count` points of [0, 1) in blocks of `block`: each block holds one
    point of each of its `block` equal strata, in a seeded order, so that
    every window's reads, whatever the seed, hold nearly the same mix of
    sizes."""
    out = []
    for _ in range(-(-count // block)):
        out.append((rng.permutation(block) + rng.random(block)) / block)
    return np.concatenate(out)[:count]


def draw_starts(data, rng, count: int) -> np.ndarray:
    """Start persons, stratified by expected degree: the generator gives
    structural person j its expected degree in the order of j, so a
    stratum of j is a stratum of the degree; `data.order` maps j to the
    person's index under the seed's labels."""
    n = len(data.ids)
    return data.order[np.minimum((strata(rng, count) * n).astype(np.int64), n - 1)]
