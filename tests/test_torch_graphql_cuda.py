"""GraphQL on the card: phase 12 of chip_smoke.py at a small size, its
filtered reads through K1 and its similarity reads through KV1 and KV2,
each kernel then held against its plain version on the inputs the reads
gave it.

The case is marked `cuda` and skips without a card. It imports no jax,
so it also runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_graphql_cuda.py
"""

import pytest
import torch

import chip_smoke
from dgraph_tpu_torch.ops import setop_rows, vector_topk


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphql_reads_launch_k1_kv1_kv2_on_the_card(card):
    """A 20-wide graph of 8,420 edges and 20,000 x 64 vectors (IVF on
    `emb`, brute on `emb_small`'s 5,000), served over the HTTP front by
    Servers on the card: every (12a)-(12e) check holds, setop_rows launched
    in (12b) and on the subscribed commits, KV1 and KV2 in (12d), and each
    equals its plain version (K1 and KV1 exactly, KV2 within
    `ivf_scan.tolerance`) on the inputs they were given."""
    quiet = lambda m: None  # noqa: E731
    data = chip_smoke.graphql_data("cuda", fanout=20, pool=20_000, n=20_000, d=64,
                                   n_named=1_000, n_small=5_000, ivf_threshold=8_000, log=quiet)
    setops, topks = setop_rows.LAUNCHES, vector_topk.LAUNCHES
    out = chip_smoke.serve_graphql(*data.values(), (), n_flips=1, reps=1, log=quiet)
    assert setop_rows.LAUNCHES > setops and vector_topk.LAUNCHES > topks
    assert min(out["launches"][k] for k in ("setop_rows", "vector_topk", "ivf_slab_scan")) >= 1
    assert out["b_setops"] >= 1 and out["commits"]["setops_per_commit_subscribed"][0] >= 1
    assert out["recall"] >= 0.9
    assert not any(chip_smoke.sweep_shapes_equal(out["sweep_shapes"]).values())
    served = chip_smoke.served_kernels(out["captured"])  # raises on a mismatch
    assert any(site.startswith("KV1") for site in served)
    assert any(site.startswith("KV2") for site in served)
