"""The ops plane on the card: K1 over an index list rolled into parts, and
KV1 after a backup is restored into a card Server.

Every test is marked `cuda` and skips without a card. They import no
jax, so they also run where only torch is installed:

    python -m pytest --noconftest tests/test_torch_ops_plane_cuda.py -m cuda
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from dgraph_tpu_torch.api.server import Server
from dgraph_tpu_torch.ops import setop_rows, vector_topk

pytestmark = pytest.mark.cuda


def _data(server, q):
    return server.query(q)["data"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def test_member_sweep_over_a_split_list_on_the_card(card, monkeypatch):
    """Query (b)-(d) over a `tag` index list rolled into parts: setop_rows
    launches on the card, and the answers equal the host path and
    numpy."""
    from dgraph_tpu_torch.posting import pl as plmod
    from dgraph_tpu_torch.posting.rollup import rollup_all

    g = chip_smoke.make_graph(20, 4000, hot_every=10)
    s = Server(device="cuda")
    chip_smoke.load_graph(s, g)
    monkeypatch.setattr(plmod, "MAX_PART_UIDS", 500)
    u = int(g["hot"][0])
    for tag in ("cold", "hot", "cold"):  # deltas on the cold list
        s.new_txn().mutate_rdf(set_rdf=f'<{hex(u)}> <tag> "{tag}" .', commit_now=True)
    rollup_all(s)
    s.new_txn().mutate_rdf(set_rdf=f'<{hex(int(g["hot"][1]))}> <tag> "cold" .', commit_now=True)
    hot = set(int(x) for x in g["hot"]) - {u, int(g["hot"][1])}
    launches = setop_rows.LAUNCHES
    with chip_smoke.forced_device():
        dev = {n: chip_smoke._run_query(s, q) for n, q in chip_smoke.QUERIES.items()}
    assert setop_rows.LAUNCHES > launches
    with chip_smoke.forced_device(False):
        host = {n: chip_smoke._run_query(s, q) for n, q in chip_smoke.QUERIES.items()}
    assert dev == host
    for name in "bcd":
        assert chip_smoke.extract(name, json.loads(dev[name])) == chip_smoke.expected(g, "b", hot)


def test_vector_topk_after_a_restore_on_the_card(card, tmp_path):
    """A backup restored into a card Server rebuilds its index on the
    card; `similar_to` launches KV1 and answers as the source."""
    from dgraph_tpu_torch.admin.backup import backup, restore
    from dgraph_tpu_torch.loaders.bulk2 import ParallelBulkLoader

    rng = np.random.default_rng(4)
    V = (rng.standard_normal((3000, 64)) * 4).astype(np.float32)
    src = Server(device="cuda")
    src.alter(chip_smoke.SMALL_SCHEMA)
    ParallelBulkLoader(src, workdir=str(tmp_path / "w"), workers=2).load_text(
        chip_smoke.vector_nquads(V, 0x10))
    backup(src, str(tmp_path / "b"))
    dst = Server(device="cuda")
    restore(dst, str(tmp_path / "b"))
    launches = vector_topk.LAUNCHES
    for q in V[:8]:
        read = '{ q(func: similar_to(emb_small, 10, "%s")) { uid } }' % chip_smoke._vec_text(q)
        assert _data(dst, read) == _data(src, read)
    assert vector_topk.LAUNCHES >= launches + 8
