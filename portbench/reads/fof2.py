"""Friends of friends of a batch of start persons: the persons two
`knows` steps from any of `roots` start persons, less the start persons
and their friends, with their ids and a count. BASELINE's batched 2-hop
(the repository's `benchmarks/ldbc_bench.py` read, many roots in one
`eq`), with the exclusion filtered where the second hop expands, so that
level's difference, one row a friend, goes through the dispatcher.

The reference answers from its own adjacency: the ids in uid order (the
generator gives uids in id order) and their count. A served answer is
judged by what it says: the list of ids under `q` and the count under
`n`, each equal to the reference's.
"""

from __future__ import annotations

import json

import numpy as np

from portbench.reads import _graph
from portbench.seeds import rng as seeded

TEXT = ("{{ me as var(func: eq(id, [{sids}])) {{ f as knows }} "
        "var(func: uid(f)) {{ fof as knows @filter(NOT uid(me) AND NOT uid(f)) }} "
        "q(func: uid(fof)) {{ id }} "
        "n(func: uid(fof)) {{ count(uid) }} }}")

# an exact comparison: every sampled answer must equal the reference's
LIMITS = {"wrong_answers": 0}


def prepare(data, params: dict, seed: int, count: int) -> list:
    k = int(params["roots"])
    starts = _graph.draw_starts(data, seeded(seed, "fof2"), count * k).reshape(count, k)
    out = []
    for row in starts:
        roots = tuple(sorted(set(int(i) for i in row)))
        out.append((TEXT.format(sids=", ".join(str(int(data.ids[i])) for i in roots)), roots))
    return out


def reference(data, adj, roots) -> dict:
    f0 = np.zeros(adj.n, bool)
    f0[list(roots)] = True
    f = adj.step(f0)
    r = adj.step(f) & ~f0 & ~f
    ids = data.ids[np.flatnonzero(r)]
    return {"ids": ids.tolist(), "count": int(ids.size)}


def served(raw) -> dict:
    a = json.loads(raw)
    return {"ids": [o.get("id") for o in a.get("q", [])],
            "count": (a.get("n") or [{}])[0].get("count")}


def check(data, params: dict, answered: list, device: str, stale_share: float = 0.0) -> dict:
    adj = _graph.adjacency(data, stale_share)
    wrong = sum(served(raw) != reference(data, adj, roots) for roots, raw in answered)
    return {"wrong_answers": wrong}


def control(data, params: dict, args: list, device: str) -> list:
    """Answers read at a stale snapshot, missing the last committed share
    of the edges: the guarantee that a read sees every acknowledged
    write, broken."""
    adj = _graph.adjacency(data, float(params["control_stale_share"]))
    out = []
    for roots in args:
        ref = reference(data, adj, roots)
        out.append(json.dumps({"q": [{"id": i} for i in ref["ids"]],
                               "n": [{"count": ref["count"]}]}).encode())
    return out
