"""The Person/knows subgraph of LDBC SNB Interactive in Dgraph's LDBC
schema, served by one `Server`.

The generator keeps SNB's shape at a scale factor's sizes: the number of
persons and of undirected knows edges, a skewed degree distribution of
that mean (a lognormal, each person's weight fixed by its rank, wired as
a Chung-Lu graph), skewed first- and last-name vocabularies, and each
person's properties and the edges' `creationDate` facets. The graph is
the same for every seed; the seed relabels its persons. Each edge is stored in both directions, as SNB's
undirected knows is. The data is loaded through `Server` transactions,
`commit_now`, in blocks of N-Quads.
"""

from __future__ import annotations

import datetime
import statistics
import time

import numpy as np

from portbench.seeds import rng as seeded

_SYL = ["ka", "ro", "mi", "sa", "te", "lu", "na", "vi", "do", "re", "ja", "el", "an",
        "to", "si", "mo", "ha", "be", "li", "ga", "no", "da", "ri", "ze", "pa", "fu",
        "ya", "ke", "lo", "ne"]
_BROWSERS = ["Firefox", "Chrome", "Internet Explorer", "Safari", "Opera"]
BASE_MS = 1262304000000  # 2010-01-01T00:00:00Z, SNB's first creationDate year


def vocabulary(n: int, salt: int) -> list:
    """n distinct capitalised ASCII names, the same in every run."""
    r = np.random.default_rng(salt)
    out, seen = [], set()
    while len(out) < n:
        k = 2 + int(r.integers(0, 3))
        w = "".join(_SYL[int(i)] for i in r.integers(0, len(_SYL), k)).capitalize()
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def degree_weights(n: int, mean: float, sigma: float, cap: float) -> np.ndarray:
    """Each person's expected degree: the lognormal's quantile at its rank,
    capped, scaled to the mean. The same in every run."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    w = np.exp(sigma * z)
    for _ in range(50):
        w = np.minimum(w * mean / w.mean(), cap)
    return w


def dt_text(ms: int) -> str:
    d = datetime.datetime.fromtimestamp(ms / 1000.0, datetime.timezone.utc)
    return d.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms % 1000:03d}Z"


def date_text(days: int) -> str:
    d = datetime.date(1980, 1, 1) + datetime.timedelta(days=int(days))
    return d.strftime("%Y-%m-%dT00:00:00Z")


class Data:
    """The raw inputs both sides are given: per person (by index) its SNB
    id, uid and properties; the undirected edges as index pairs."""

    def __init__(self, config: dict):
        self.config = config


def generate(config: dict, seed: int, device: str, log=print) -> Data:
    """The graph and its properties, the same for every seed but for the
    persons' labels: the seed permutes which id, uid and place in the
    commit order each person takes, so every seed serves the same work
    (the same degrees, reaches and name counts) under other names."""
    t0 = time.perf_counter()
    c = config
    n, m = int(c["persons"]), int(c["knows_edges"])
    r = np.random.default_rng(np.random.SeedSequence([0x1DBC, n, m]))
    first = vocabulary(int(c["first_names"]), 1)
    last = vocabulary(int(c["last_names"]), 2)
    props = {
        "first": r.choice(len(first), n, p=zipf_weights(len(first), float(c["first_name_zipf"]))),
        "last": r.choice(len(last), n, p=zipf_weights(len(last), float(c["last_name_zipf"]))),
        "gender": r.integers(0, 2, n),
        "birthday": r.integers(0, 365 * 20, n),  # days after 1980-01-01
        "creation": BASE_MS + r.integers(0, 3 * 365 * 86_400_000, n),
        "ip": r.integers(0, 1 << 32, n, dtype=np.int64),
        "browser": r.integers(0, len(_BROWSERS), n),
    }
    w = degree_weights(n, 2.0 * m / n, float(c["degree_sigma"]), float(c["degree_cap"]))
    p = w / w.sum()
    got = np.zeros((0,), np.int64)
    while got.size < m:
        draw = int(1.3 * (m - got.size)) + 1024
        a, b = r.choice(n, draw, p=p), r.choice(n, draw, p=p)
        keep = a != b
        key = np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep]
        allk = np.concatenate([got, key])
        _, first_at = np.unique(allk, return_index=True)
        got = allk[np.sort(first_at)]
    got = got[:m]
    edge_ms = BASE_MS + r.integers(0, 3 * 365 * 86_400_000, m)
    # the seed's labels: structural person j is person order[j]
    order = seeded(seed, "graph").permutation(n)
    data = Data(config)
    data.order = order
    data.ids = 933 + 7 * np.arange(n, dtype=np.int64)  # SNB-like sparse person ids
    data.uids = int(c["uid_base"]) + np.arange(n, dtype=np.int64)
    data.first_vocab, data.last_vocab = first, last
    for k, v in props.items():
        out = np.empty_like(v)
        out[order] = v
        setattr(data, k, out)
    data.edges = order[np.stack([got // n, got % n], 1)].astype(np.int64)
    data.edge_ms = edge_ms
    log(f"graph {n} persons, {m} knows edges made in {time.perf_counter() - t0:.3f} s")
    return data


def person_fields(data: Data, i: int) -> dict:
    """Person i's served fields as the reference knows them."""
    ip = int(data.ip[i])
    return {
        "id": int(data.ids[i]),
        "firstName": data.first_vocab[int(data.first[i])],
        "lastName": data.last_vocab[int(data.last[i])],
        "gender": "male" if data.gender[i] else "female",
        "birthday": date_text(int(data.birthday[i])),
        "creationDate": dt_text(int(data.creation[i])),
        "locationIP": f"{ip >> 24}.{(ip >> 16) & 255}.{(ip >> 8) & 255}.{ip & 255}",
        "browserUsed": _BROWSERS[int(data.browser[i])],
    }


def nquads(data: Data):
    """The data as blocks of N-Quads: persons first, then the edges."""
    n = len(data.ids)
    lines = []
    for i in range(n):
        u = f"<{hex(int(data.uids[i]))}>"
        f = person_fields(data, i)
        lines += [
            f'{u} <dgraph.type> "Person" .',
            f'{u} <id> "{f["id"]}"^^<xs:int> .',
            f'{u} <firstName> "{f["firstName"]}" .',
            f'{u} <lastName> "{f["lastName"]}" .',
            f'{u} <gender> "{f["gender"]}" .',
            f'{u} <birthday> "{f["birthday"]}"^^<xs:dateTime> .',
            f'{u} <creationDate> "{f["creationDate"]}"^^<xs:dateTime> .',
            f'{u} <locationIP> "{f["locationIP"]}" .',
            f'{u} <browserUsed> "{f["browserUsed"]}" .',
        ]
    yield lines
    hx = [hex(int(u)) for u in data.uids]
    step = 20_000
    for s in range(0, len(data.edges), step):
        lines = []
        for (a, b), ms in zip(data.edges[s : s + step].tolist(), data.edge_ms[s : s + step].tolist()):
            facet = f"(creationDate={dt_text(ms)})"
            lines.append(f"<{hx[a]}> <knows> <{hx[b]}> {facet} .")
            lines.append(f"<{hx[b]}> <knows> <{hx[a]}> {facet} .")
        yield lines


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
    count = 0
    for block in nquads(data):
        for s in range(0, len(block), 40_000):
            part = block[s : s + 40_000]
            server.new_txn().mutate_rdf(set_rdf="\n".join(part), commit_now=True)
            count += len(part)
    log(f"loaded {count} N-Quads in {time.perf_counter() - t0:.3f} s")
    return State(server, data)
