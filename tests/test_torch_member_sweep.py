"""The member sweep (K1) against the Pallas kernel it replaces.

`dgraph_tpu_torch/ops/member_sweep.py` holds the hand-written CUDA kernel's
wrapper and, beside it, the plain PyTorch version that CPU tensors take.
Here the plain version runs against `dgraph_tpu/ops/pallas_setops.py`
in interpret mode on the same seeded inputs; masks, compacted rows and
counts must be equal exactly. The kernel itself runs only on an NVIDIA
card: its test is marked `cuda` and skips without one. jax is imported
by the tests that compare with it, so the `cuda` test also runs where
only torch is installed:

    python -m pytest --noconftest tests/test_torch_member_sweep.py -m cuda
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.ops import member_sweep, setops as tset


def _reference():
    """(jax.numpy, the Pallas module) of the JAX package."""
    import jax.numpy as jnp

    from dgraph_tpu.ops import pallas_setops

    return jnp, pallas_setops


U32 = 0xFFFFFFFF


# value ranges of the row kinds: "sign" keeps every uid within 2048 of
# 2^31, so rows mix values below and above it (a signed compare fails)
_RANGES = {"plain": (0, 1 << 32), "equal": (0, 1 << 32),
           "sign": ((1 << 31) - 2048, (1 << 31) + 2048)}


def _rows(seed, n, pa, pb, zero_pad=False, kind="plain"):
    """n rows: A (n, pa) queries, about half of them members of B (n, pb).
    B's tail past LB holds zeros when `zero_pad`, else UINT32_MAX.
    `kind` "equal" repeats every query of A once; "sign" draws all values
    around 2^31."""
    rng = np.random.default_rng(seed)
    lo, hi = _RANGES[kind]
    A = np.full((n, pa), U32, np.uint32)
    B = np.full((n, pb), 0 if zero_pad else U32, np.uint32)
    LA = np.zeros((n,), np.int32)
    LB = np.zeros((n,), np.int32)
    for i in range(n):
        lb = int(rng.integers(0, pb + 1))
        b = np.unique(rng.integers(lo, hi, size=lb, dtype=np.uint64)).astype(
            np.uint32
        )
        la = int(rng.integers(0, pa + 1))
        mix = np.concatenate(
            [rng.choice(b, size=min(len(b), la // 2)) if len(b) else b,
             rng.integers(lo, hi, size=la, dtype=np.uint64).astype(np.uint32)]
        )
        a = np.unique(mix)
        a = (np.repeat(a, 2) if kind == "equal" else a)[:la]
        A[i, : len(a)], LA[i] = a, len(a)
        B[i, : len(b)], LB[i] = b, len(b)
    return A, LA, B, LB


def _port_args(A, LA, B, LB, device="cpu"):
    return [torch.from_numpy(x.view(np.int32)).to(device) for x in (A, LA, B, LB)]


CASES = [(1, 1, 8), (3, 8, 1024), (4, 64, 2048), (2, 128, 3000), (5, 100, 1)]
# CASES, then rows with equal queries and rows straddling 2^31
KIND_CASES = [pytest.param(*c, "plain", id="-".join(map(str, c))) for c in CASES] + [
    pytest.param(n, pa, pb, kind, id=f"{n}-{pa}-{pb}-{kind}")
    for kind in ("equal", "sign")
    for n, pa, pb in ((3, 8, 1024), (2, 128, 3000))
]


@pytest.mark.parametrize("n,pa,pb,kind", KIND_CASES)
@pytest.mark.parametrize("zero_pad", [False, True])
def test_plain_membership_matches_pallas(n, pa, pb, kind, zero_pad):
    jnp, pallas_setops = _reference()
    A, LA, B, LB = _rows(n * pa + pb, n, pa, pb, zero_pad, kind)
    want = np.asarray(
        pallas_setops.membership_batch(
            jnp.asarray(A), jnp.asarray(LA), jnp.asarray(B), jnp.asarray(LB),
            interpret=True,
        )
    )
    got = member_sweep.membership_batch(*_port_args(A, LA, B, LB))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,pa,pb,kind", KIND_CASES)
def test_plain_intersect_matches_pallas(n, pa, pb, kind):
    jnp, pallas_setops = _reference()
    A, LA, B, LB = _rows(n + pa * pb, n, pa, pb, kind=kind)
    out, cnt = pallas_setops.intersect_batch(
        jnp.asarray(A), jnp.asarray(LA), jnp.asarray(B), jnp.asarray(LB),
        interpret=True,
    )
    got_out, got_cnt = member_sweep.intersect_batch(*_port_args(A, LA, B, LB))
    np.testing.assert_array_equal(got_out.numpy().view(np.uint32), np.asarray(out))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(cnt))


@pytest.mark.parametrize(
    "a,b,want",
    [
        ([1, U32], [U32], [False, True]),  # the sentinel is a legal uid
        ([0], [5], [False]),  # zero padding of b never hits
        ([0, 5], [0, 5], [True, True]),
    ],
)
def test_single_row_edge_cases_match_pallas(a, b, want):
    jnp, pallas_setops = _reference()
    a = np.array(a, np.uint32)
    b = np.array(b, np.uint32)
    A, B = tset.pad_sorted(a, 8), tset.pad_sorted(b, 8)
    ref = np.asarray(
        pallas_setops.membership(
            jnp.asarray(A), len(a), jnp.asarray(B), len(b), interpret=True
        )
    )
    got = member_sweep.membership(
        torch.from_numpy(A.view(np.int32)), len(a),
        torch.from_numpy(B.view(np.int32)), len(b),
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[: len(a)], want)
    out, n = member_sweep.intersect(
        torch.from_numpy(A.view(np.int32)), len(a),
        torch.from_numpy(B.view(np.int32)), len(b),
    )
    rout, rn = pallas_setops.intersect(
        jnp.asarray(A), len(a), jnp.asarray(B), len(b), interpret=True
    )
    assert int(n) == int(rn)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(rout))


def test_plain_counts_apart_from_launches():
    A, LA, B, LB = _rows(1, 2, 8, 16)
    launches, plain = member_sweep.LAUNCHES, member_sweep.PLAIN_CALLS
    member_sweep.membership_batch(*_port_args(A, LA, B, LB))
    assert member_sweep.LAUNCHES == launches
    assert member_sweep.PLAIN_CALLS == plain + 1


@pytest.mark.parametrize(
    "bad",
    [
        lambda A, LA, B, LB: (A.to(torch.int64), LA, B, LB),  # dtype
        lambda A, LA, B, LB: (A, LA[:1], B, LB),  # LA shape
        lambda A, LA, B, LB: (A[:1], LA[:1], B, LB),  # rows differ
        lambda A, LA, B, LB: (  # more than 128 queries
            torch.zeros((A.shape[0], 129), dtype=torch.int32), LA, B, LB
        ),
        lambda A, LA, B, LB: (  # rows of 2^31 elements, as a stride-0 view
            A, LA, B[:, :1].expand(B.shape[0], 1 << 31), LB
        ),
    ],
)
def test_wrapper_rejects_bad_inputs(bad):
    A, LA, B, LB = _port_args(*_rows(2, 2, 8, 16))
    with pytest.raises((TypeError, ValueError)):
        member_sweep.membership_batch(*bad(A, LA, B, LB))


@pytest.mark.cuda
@pytest.mark.parametrize("n,pa,pb", CASES + [(64, 128, 65536)])
def test_kernel_matches_plain_on_card(n, pa, pb):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ only")
    for zero_pad in (False, True):
        A, LA, B, LB = _rows(n + pa + pb, n, pa, pb, zero_pad)
        args = _port_args(A, LA, B, LB, "cuda")
        launches = member_sweep.LAUNCHES
        got = member_sweep.membership_batch(*args)
        torch.cuda.synchronize()
        assert member_sweep.LAUNCHES == launches + 1
        want = member_sweep.membership_batch_plain(*args)
        assert torch.equal(got, want)


def _special_rows(case, seed=5):
    """Rows at the kernel's edges, as numpy (A, LA, B, LB)."""
    rng = np.random.default_rng(seed)

    def sorted_rows(n, pa, pb, la, lb, lo=0, hi=1 << 32, dup=False):
        A = np.full((n, pa), U32, np.uint32)
        B = np.full((n, pb), U32, np.uint32)
        for i in range(n):
            b = lo + np.sort(rng.choice(hi - lo, size=lb[i], replace=False))
            B[i, : lb[i]] = b
            pick = rng.choice(b, size=la[i]) if len(b) else np.zeros(0, np.uint64)
            fresh = rng.integers(lo, hi, size=la[i], dtype=np.uint64)
            a = np.sort(np.where(rng.random(la[i]) < 0.5, pick, fresh) if len(b) else fresh)
            if dup:
                a = np.repeat(a, 2)[: la[i]]
            A[i, : la[i]] = a
        return A, la.astype(np.int32), B, lb.astype(np.int32)

    if case in ("switch", "equal", "mixed_sign"):
        # LB one below and at the kernel's switch (streamed, then
        # searched), and at the reference's 32 LA, row by row
        la = rng.integers(1, 65, size=64)
        at = np.array([member_sweep.search_from(k) for k in la])
        lb = np.where(np.arange(64) % 4 < 2, at, 32 * la) - (np.arange(64) % 2)
        lo, hi = ((1 << 31) - 8192, (1 << 31) + 8192) if case == "mixed_sign" else (0, 1 << 32)
        return sorted_rows(64, 64, int(lb.max()), la, lb, lo, hi, dup=case == "equal")
    if case == "la0":
        return sorted_rows(16, 8, 512, np.zeros(16, np.int64), np.full(16, 300))
    if case == "lb0":
        return sorted_rows(16, 8, 512, np.full(16, 8), np.zeros(16, np.int64))
    if case == "pb_lt_8":  # 12-byte rows: 32-byte sectors and 16-byte loads straddle rows
        return sorted_rows(37, 5, 3, rng.integers(0, 6, size=37), rng.integers(0, 4, size=37))
    if case == "long_row":  # one searched row of 2^26 strictly increasing uids
        pb = 1 << 26
        B = (np.arange(pb, dtype=np.uint64) * 64 + rng.integers(0, 64, size=pb)).astype(np.uint32)
        a = np.sort(np.concatenate([rng.choice(B, 64), rng.integers(0, 1 << 32, 64).astype(np.uint32)]))
        return a[None, :], np.array([128], np.int32), B[None, :], np.array([pb], np.int32)
    raise ValueError(case)


# the regimes each case's rows reach, by the kernel's own rule
_EDGE_REGIMES = {
    "switch": {"search", "stream"}, "la0": set(), "lb0": set(),
    "pb_lt_8": {"stream"}, "long_row": {"search"},
    "mixed_sign": {"search", "stream"}, "equal": {"search", "stream"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_EDGE_REGIMES))
def test_kernel_edge_rows_on_card(case):
    """Both sides of the search/stream switch, empty rows, rows shorter
    than a sector, one long row, values straddling 2^31, equal queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ only")
    A, LA, B, LB = _special_rows(case)
    reached = {
        "search" if lb >= member_sweep.search_from(la) else "stream"
        for la, lb in zip(LA.tolist(), LB.tolist()) if la > 0 and lb > 0
    }
    assert reached == _EDGE_REGIMES[case]
    args = _port_args(A, LA, B, LB, "cuda")
    want = member_sweep.membership_batch_plain(*args)
    ref = np.zeros(A.shape, bool)
    for i in range(A.shape[0]):
        ref[i, : LA[i]] = np.isin(A[i, : LA[i]], B[i, : LB[i]])
    np.testing.assert_array_equal(want.cpu().numpy(), ref)
    got = member_sweep.membership_batch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want), case
