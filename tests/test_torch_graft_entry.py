"""The port's entry points (`__graft_entry_torch__.py`) against the JAX
package's (`__graft_entry__.py`), on the CPU.

- `entry(device="cpu")`'s step against the reference's `entry()` step
  run in jax: the same inputs (the same seed, drawn in the same order);
  intersections and counts equal; top-k ids equal but at float32
  near-ties of the exact float64 distances, whose values agree within
  RTOL. The entry's 30-bit rows almost never meet, so both steps also
  take rows of b that hold half of a's row and UINT32_MAX as a uid.
- `dryrun_multichip(4, device="cpu")` in a subprocess where jax and
  `dgraph_tpu` cannot be imported (the blocker of
  tests/test_torch_isolation.py): it exits 0 and prints the reference's
  OK lines, with at least one sharded dispatch.
- chip_smoke's (13c) rehearsed on the host.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
import __graft_entry_torch__ as graft
import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _exact_d(V, Q, ids):
    """Float64 squared distances of the rows `ids` (nq, k) of V to Q."""
    diff = V[ids].astype(np.float64) - Q.astype(np.float64)[:, None, :]
    return (diff * diff).sum(axis=2)


def test_entry_matches_reference():
    step, args = graft.entry(device="cpu")
    ref_step, ref_args = ref_entry.entry()
    A, LA, B, LB, V, Q = (np.asarray(x) for x in ref_args)
    np.testing.assert_array_equal(args[0].numpy().view(np.uint32), A)
    np.testing.assert_array_equal(args[2].numpy().view(np.uint32), B)
    for got, want in zip((args[1], args[3], args[4], args[5]), (LA, LB, V, Q)):
        np.testing.assert_array_equal(got.numpy(), want)
    out, cnt, idx = step(*args)
    r_out, r_cnt, r_idx = (np.asarray(x) for x in ref_step(*ref_args))
    assert out.device.type == "cpu" and tuple(out.shape) == r_out.shape
    np.testing.assert_array_equal(out.numpy(), r_out.astype(np.int64))
    np.testing.assert_array_equal(cnt.numpy(), r_cnt)
    idx = idx.numpy()
    assert idx.shape == r_idx.shape == (32, 10)
    got_d, want_d = _exact_d(V, Q, idx), _exact_d(V, Q, r_idx)
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL)
    for i in range(len(idx)):
        if not np.array_equal(idx[i], r_idx[i]):  # only where the float32 sums near-tie
            assert np.allclose(np.sort(got_d[i]), np.sort(want_d[i]), rtol=RTOL)
    assert sum(np.array_equal(a, b) for a, b in zip(idx, r_idx)) >= 30


def test_entry_step_on_overlapping_rows():
    """Both steps on the entry's rows with half of each a row (and
    UINT32_MAX, a uid, in a and b) merged into its b row: equal
    intersections and counts, and numpy's."""
    step, args = graft.entry(device="cpu")
    ref_step, ref_args = ref_entry.entry()
    A, LA, B, LB = (np.array(x) for x in ref_args[:4])
    rng = np.random.default_rng(3)
    for i in range(len(A)):
        a = A[i, : LA[i]]
        a[-1] = 0xFFFFFFFF
        b = np.unique(np.concatenate([B[i, : LB[i] - len(a) // 2 - 1],
                                      rng.choice(a, len(a) // 2, replace=False), [a[-1]]]))
        B[i], LB[i] = 0xFFFFFFFF, len(b)
        B[i, : len(b)] = b
    import jax.numpy as jnp

    r_out, r_cnt, _ = ref_step(jnp.asarray(A), jnp.asarray(LA), jnp.asarray(B),
                               jnp.asarray(LB), *ref_args[4:])
    t = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)  # noqa: E731
    out, cnt, _ = step(t(A), t(LA), t(B), t(LB), *args[4:])
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out).astype(np.int64))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(r_cnt))
    for i in range(len(A)):
        want = np.intersect1d(A[i, : LA[i]], B[i, : LB[i]])
        assert cnt[i] == len(want) >= LA[i] // 2 and want[-1] == 0xFFFFFFFF
        np.testing.assert_array_equal(out[i, : cnt[i]].numpy(), want)


def test_entry_asks_for_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        graft.entry()
    with pytest.raises(RuntimeError):
        graft.dryrun_multichip(4)


_BLOCKED_DRYRUN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dgraph_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import __graft_entry_torch__ as g

g.dryrun_multichip(4, device="cpu")
assert "jax" not in sys.modules and "dgraph_tpu" not in sys.modules
"""


def test_dryrun_multichip_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _BLOCKED_DRYRUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = run.stdout.splitlines()
    assert ("dryrun_multichip OK on 4 devices: kmeans (4, 8), topk (3,), "
            "membership (32,), rows_membership (4, 16)") in lines
    assert "the mesh: 4 shards on 1 distinct device (cpu)" in lines
    got = [re.fullmatch(r"distributed query OK on the 4-device mesh: 2 groups, "
                        r"(\d+) sharded dispatches, 7 rows", ln) for ln in lines]
    assert any(m and int(m.group(1)) > 0 for m in got), run.stdout


def test_graft_entry_phase_on_cpu():
    """chip_smoke's (13c) on the host: entry() against itself on the host
    and numpy, and the dry run on MESH_SHARDS host shards, whose k-means
    step hands KV4's wrapper one shard shape, held to its plain version."""
    out = chip_smoke.graft_entry("cpu", log=lambda m: None)
    assert out["entry"]["ids_equal_host"] == out["entry"]["rows"] == 32
    assert out["entry"]["ms"] is None  # no time without a card
    assert out["dryrun"]["s"] > 0
    assert list(out["dryrun"]["kv4"]) == ["KV4 16x8 c=4"]
    assert out["dryrun"]["kv4"]["KV4 16x8 c=4"]["mismatches"] == 0
