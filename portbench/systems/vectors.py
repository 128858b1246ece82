"""A vector corpus on one float32vector predicate, served by one
`Server` for `similar_to` reads.

The rows stand in for a published embedding set that cannot be fetched
here: a mixture of `clusters` clusters of Zipf(`cluster_zipf`) sizes,
each a centre drawn from N(0, I_d) plus a random `manifold_dim`-wide
orthonormal basis times N(0, `manifold_sigma`^2 I), plus N(0,
`noise_sigma`^2 I_d) noise, each row then scaled to a lognormal(0,
`norm_sigma`) norm, as an unnormalised embedding model gives rows of
unequal norm. The held-out queries come from the same mixture, their
clusters drawn by the clusters' sizes.

The rows and queries are the same for every seed: they are drawn on the
run's device from a fixed generator, in bulk. The seed relabels them: it
permutes which uid, `id` and place in the commit order each row takes,
so every seed serves the same work under other names. Row i of
`Data.vecs` is the row with uid `uid_base + i` and `id` i. The rows are
loaded through `Server` transactions, `commit_now`, as JSON mutations of
`block` rows each.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.seeds import torch_seed

DATA_SEED = 0x7EC1768


def zipf_sizes(n: int, clusters: int, s: float) -> np.ndarray:
    """Cluster sizes summing to n, proportional to 1 / rank^s (largest
    remainders take the rows left over). The same in every run."""
    w = 1.0 / np.arange(1, clusters + 1, dtype=np.float64) ** s
    exact = n * w / w.sum()
    sizes = np.floor(exact).astype(np.int64)
    left = n - int(sizes.sum())
    sizes[np.argsort(-(exact - sizes), kind="stable")[:left]] += 1
    return sizes


def _mixture(c: dict, gen, device: str):
    """The clusters' centres (k, d) and orthonormal bases (k, d, m)."""
    import torch

    k, d, m = int(c["clusters"]), int(c["dim"]), int(c["manifold_dim"])
    centres = torch.randn((k, d), generator=gen, device=device)
    bases, _ = torch.linalg.qr(torch.randn((k, d, m), generator=gen, device=device))
    return centres, bases


def draw(c: dict, centres, bases, labels, gen, device: str):
    """Rows of the mixture for cluster `labels` (n,) (a torch tensor on
    `device`), drawn in label order: (n, d) float32."""
    import torch

    n = labels.numel()
    d, m = centres.shape[1], bases.shape[2]
    X = centres[labels]
    z = torch.randn((n, m), generator=gen, device=device) * float(c["manifold_sigma"])
    # rows come sorted by label: one small GEMM a cluster
    cut = torch.searchsorted(labels, torch.arange(centres.shape[0] + 1, device=device)).tolist()
    for j in range(centres.shape[0]):
        if cut[j + 1] > cut[j]:
            X[cut[j] : cut[j + 1]] += z[cut[j] : cut[j + 1]] @ bases[j].T
    step = 1 << 17
    for s in range(0, n, step):
        e = min(n, s + step)
        X[s:e] += torch.randn((e - s, d), generator=gen, device=device) * float(c["noise_sigma"])
    norm = torch.exp(torch.randn((n,), generator=gen, device=device) * float(c["norm_sigma"]))
    X *= (norm / X.norm(dim=1))[:, None]
    return X


class Data:
    """The raw inputs both sides are given: `vecs` (rows, d) float32, row
    i being the row of uid `uid_base + i` and `id` i; `queries` (q, d)
    float32, the held-out queries; `metric`, `k`."""

    def __init__(self, config: dict):
        self.config = config


def generate(config: dict, seed: int, device: str, log=print) -> Data:
    import torch

    t0 = time.perf_counter()
    c = config
    n, nq = int(c["rows"]), int(c["queries"])
    gen = torch.Generator(device=device)
    gen.manual_seed(DATA_SEED)
    centres, bases = _mixture(c, gen, device)
    sizes = zipf_sizes(n, int(c["clusters"]), float(c["cluster_zipf"]))
    labels = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), torch.from_numpy(sizes).to(device))
    X = draw(c, centres, bases, labels, gen, device)
    w = torch.from_numpy(sizes / sizes.sum()).to(device)
    qlab = torch.sort(torch.multinomial(w, nq, replacement=True, generator=gen)).values
    Q = draw(c, centres, bases, qlab, gen, device)
    # the queries in an order of their own, not by cluster
    Q = Q[torch.randperm(nq, generator=gen, device=device)]
    # the seed's labels: structural row j is row perm[j]
    g = torch.Generator(device="cpu")
    g.manual_seed(torch_seed(seed, "rows"))
    perm = torch.randperm(n, generator=g).to(device)
    out = torch.empty_like(X)
    out[perm] = X
    del X
    data = Data(config)
    data.vecs = out.cpu().numpy()
    data.queries = Q.cpu().numpy()
    data.metric = c["metric"]
    data.k = int(c["k"])
    data.uid_base = int(c["uid_base"])
    log(f"{n} x {c['dim']} rows in {len(sizes)} clusters and {nq} queries made on {device} in "
        f"{time.perf_counter() - t0:.3f} s")
    return data


def blocks(data: Data, block: int):
    """The rows as JSON mutation objects, `block` rows a list."""
    n = len(data.vecs)
    for s in range(0, n, block):
        e = min(n, s + block)
        yield [{"uid": hex(data.uid_base + i), "id": i, "emb": v}
               for i, v in zip(range(s, e), data.vecs[s:e].tolist())]


class State:
    def __init__(self, server, data: Data):
        self.server = server
        self.data = data

    def close(self):
        self.server = None


def load(config: dict, data: Data, device: str, log=print) -> State:
    from dgraph_tpu_torch.api.server import Server

    t0 = time.perf_counter()
    server = Server(device=device)
    server.alter(config["schema"])
    commit0 = _commit_spans()
    count, built, mutated = 0, 0.0, 0.0
    it = blocks(data, int(config["block"]))
    while True:
        t1 = time.perf_counter()
        objs = next(it, None)
        t2 = time.perf_counter()
        built += t2 - t1
        if objs is None:
            break
        server.new_txn().mutate_json(set_obj=objs, commit_now=True)
        mutated += time.perf_counter() - t2
        count += len(objs)
    # the load split: the mutation objects built here, and the server's
    # mutate_json, of which its `commit` spans (the rest parses the
    # objects and applies their edges)
    commit = _commit_spans() - commit0
    log(f"committed {count} rows in {time.perf_counter() - t0:.3f} s: objects built "
        f"{built:.3f} s, mutate_json {mutated:.3f} s (commit spans {commit:.3f} s)")
    return State(server, data)


def _commit_spans() -> float:
    """Seconds in the program's `commit` spans so far (0 where none
    ended)."""
    from dgraph_tpu_torch.utils.observe import METRICS

    return float(METRICS.hist_stats("span_commit_seconds")[0])
