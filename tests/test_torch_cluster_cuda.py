"""The cluster on the card: a ProcCluster's coordinator answers query (b)
with K1 launched on its card, and the cluster entry points refuse to
start without one.

The card case is marked `cuda` and skips without a card; the refusal
case runs everywhere (without a card it is what happens anyway; with
one, `torch.cuda.is_available` is made to say there is none). They
import no jax, so they also run where only torch is installed:

    python -m pytest --noconftest tests/test_torch_cluster_cuda.py
"""

import json
import subprocess

import pytest
import torch

import chip_smoke
from dgraph_tpu_torch.ops import setop_rows
from dgraph_tpu_torch.worker import groups
from dgraph_tpu_torch.worker.groups import DistributedCluster
from dgraph_tpu_torch.worker.harness import ProcCluster


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_proc_cluster_answers_b_with_k1_on_the_card(card, tmp_path):
    """1 group x 3 replica processes over a small graph: (b) on the
    forced device path equals the host path and numpy, its filtered level
    launched setop_rows on the coordinator's card, and no replica maps the CUDA driver."""
    g = chip_smoke.make_graph(10, 2000, roots=5)
    c = ProcCluster(device="cuda", n_groups=1, replicas=3, data_dir=str(tmp_path))
    try:
        c.alter(chip_smoke.CLUSTER_SCHEMA)
        for text in chip_smoke.nquad_chunks(g, 2000):
            c.new_txn().mutate_rdf(set_rdf=text, commit_now=True)
        chip_smoke.check_replicas_off_card(c, on_card=True)
        launches = setop_rows.LAUNCHES
        with chip_smoke.forced_device():
            dev = c.query(chip_smoke.QUERIES["b"], want="raw")["data"].raw
        assert setop_rows.LAUNCHES > launches
        with chip_smoke.forced_device(False):
            host = c.query(chip_smoke.QUERIES["b"], want="raw")["data"].raw
        assert dev == host
        assert chip_smoke.extract("b", json.loads(dev)) == chip_smoke.expected(g, "b")
    finally:
        c.close()
    assert chip_smoke.cluster_children() == {}


def test_cluster_entry_points_raise_without_a_card(monkeypatch):
    """`ProcCluster()` and `DistributedCluster()` ask for the card by
    default and raise before they spawn a process or build a group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def spawned(*a, **kw):
        raise AssertionError("a process was spawned")

    def built(*a, **kw):
        raise AssertionError("a group was built")

    monkeypatch.setattr(subprocess, "Popen", spawned)
    monkeypatch.setattr(groups, "AlphaGroup", built)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        ProcCluster(n_groups=1, replicas=1)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        DistributedCluster(n_groups=1, replicas=1)
    assert chip_smoke.cluster_children() == {}
