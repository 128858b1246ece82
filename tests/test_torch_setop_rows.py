"""setop_rows (K2 + K3) against the XLA set ops it replaces.

`dgraph_tpu_torch/ops/setop_rows.py` holds the hand-written CUDA kernel's
wrappers (`intersect_batch`, `difference_batch`, `compact_batch`) and,
beside them, their plain PyTorch versions, which CPU tensors take. Here
the plain versions run against the reference's `jax.vmap` of
`dgraph_tpu.ops.setops.intersect`, `difference` and `compact` on the same
seeded rows (`chip_smoke.setop_rows_case`), in both of the dispatcher's
forms: a b per row (`jax.vmap`) and one b shared by every row
(`in_axes=(0, 0, None, None)`); outputs and counts must be equal exactly.
The member sweep (K1) takes the shared form too (B row stride 0). The
kernels themselves run only on an NVIDIA card: those tests are marked
`cuda` and skip without one:

    python -m pytest --noconftest tests/test_torch_setop_rows.py -m cuda
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dgraph_tpu_torch.ops import member_sweep, setop_rows

U32 = 0xFFFFFFFF
SHAPES = [(3, 1, 8), (5, 8, 40), (4, 128, 300), (3, 129, 500), (2, 300, 700), (1, 1000, 3000)]


def _t(arrays, device="cpu"):
    return [torch.from_numpy(x).to(device) for x in arrays]


def _reference(op, A, LA, B, LB):
    """The reference's vmapped set op on the same rows, as numpy."""
    import jax
    import jax.numpy as jnp

    from dgraph_tpu.ops import setops

    fn = getattr(setops, op)
    a, b = jnp.asarray(A.view(np.uint32)), jnp.asarray(B.view(np.uint32))
    if B.ndim == 1:
        out, cnt = jax.vmap(fn, in_axes=(0, 0, None, None))(a, jnp.asarray(LA), b, int(LB[0]))
    else:
        out, cnt = jax.vmap(fn)(a, jnp.asarray(LA), b, jnp.asarray(LB))
    return np.asarray(out), np.asarray(cnt)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("kind", chip_smoke.SETOP_KINDS)
@pytest.mark.parametrize("shared", [False, True], ids=["paired", "shared"])
@pytest.mark.parametrize("op", ["intersect", "difference"])
def test_plain_matches_reference(op, shared, kind, shape):
    n, pa, pb = shape
    case = chip_smoke.setop_rows_case(n, pa, pb, seed=n + pa * 7 + pb, kind=kind, shared=shared)
    want_out, want_cnt = _reference(op, *case)
    out, cnt = getattr(setop_rows, f"{op}_batch")(*_t(case))
    assert out.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want_out)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_compact_matches_reference(shape):
    import jax
    import jax.numpy as jnp

    from dgraph_tpu.ops import setops

    n, pa, pb = shape
    A, _, _, _ = chip_smoke.setop_rows_case(n, pa, pb, seed=pa, kind="max")
    keep = np.random.default_rng(pa).random((n, pa)) < 0.4
    want_out, want_cnt = jax.vmap(setops.compact)(jnp.asarray(A.view(np.uint32)), jnp.asarray(keep))
    out, cnt = setop_rows.compact_batch(torch.from_numpy(A), torch.from_numpy(keep))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(want_out))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


@pytest.mark.parametrize(
    "a,b,want",
    [
        ([1, U32], [U32], [U32]),  # the sentinel is a legal uid
        ([0, 5], [5], [5]),
        ([], [5], []),  # la of 0
        ([3, 4], [], []),  # lb of 0
        ([7, 7, 9], [7, 9], [7, 7, 9]),  # equal queries are each kept
    ],
)
def test_single_rows(a, b, want):
    A = np.full((1, 4), U32, np.uint32)
    B = np.full((4,), 0, np.uint32)  # zeros past lb never hit
    A[0, : len(a)], B[: len(b)] = a, b
    args = _t([A.view(np.int32), np.array([len(a)], np.int32), B.view(np.int32),
               np.array([len(b)], np.int32)])
    out, cnt = setop_rows.intersect_batch(*args)
    assert out[0, : int(cnt[0])].numpy().view(np.uint32).tolist() == want
    out, cnt = setop_rows.difference_batch(*args)
    kept = [x for x in a if x not in b]
    assert out[0].numpy().view(np.uint32).tolist() == kept + [U32] * (4 - len(kept))


def test_member_sweep_takes_a_shared_b():
    """K1 with one B for every row (stride 0) equals K1 with B repeated,
    and the reference's vmapped membership with in_axes (0, 0, None,
    None); its intersect then compacts through setop_rows."""
    import jax
    import jax.numpy as jnp

    from dgraph_tpu.ops import setops

    A, LA, B, LB = chip_smoke.setop_rows_case(7, 64, 900, seed=3, kind="max", shared=True)
    shared = member_sweep.membership_batch(*_t([A, LA, B, LB]))
    rep = member_sweep.membership_batch(*_t([A, LA, np.tile(B, (7, 1)), np.repeat(LB, 7)]))
    want = jax.vmap(setops.membership, in_axes=(0, 0, None, None))(
        jnp.asarray(A.view(np.uint32)), jnp.asarray(LA), jnp.asarray(B.view(np.uint32)),
        int(LB[0]))
    assert torch.equal(shared, rep)
    np.testing.assert_array_equal(shared.numpy(), np.asarray(want))
    plain = setop_rows.PLAIN_CALLS
    out, cnt = member_sweep.intersect_batch(*_t([A, LA, B, LB]))
    assert setop_rows.PLAIN_CALLS == plain + 1
    want_out, want_cnt = _reference("intersect", A, LA, B, LB)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want_out)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def test_plain_counts_apart_from_launches():
    case = _t(chip_smoke.setop_rows_case(2, 8, 16, seed=1))
    launches, plain = setop_rows.LAUNCHES, setop_rows.PLAIN_CALLS
    setop_rows.intersect_batch(*case)
    setop_rows.difference_batch(*case)
    setop_rows.compact_batch(case[0], torch.ones(case[0].shape, dtype=torch.bool))
    assert setop_rows.LAUNCHES == launches
    assert setop_rows.PLAIN_CALLS == plain + 3


@pytest.mark.parametrize(
    "bad",
    [
        lambda A, LA, B, LB: (A.to(torch.int64), LA, B, LB),  # dtype
        lambda A, LA, B, LB: (A, LA[:1], B, LB),  # LA shape
        lambda A, LA, B, LB: (A[:1], LA[:1], B, LB),  # rows differ
        lambda A, LA, B, LB: (A, LA, B[0], LB),  # a shared B with a length a row
        lambda A, LA, B, LB: (A, LA, B[:, :1].expand(B.shape[0], 1 << 31), LB),  # too long
    ],
)
def test_wrapper_rejects_bad_inputs(bad):
    A, LA, B, LB = _t(chip_smoke.setop_rows_case(2, 8, 16, seed=2))
    with pytest.raises((TypeError, ValueError)):
        setop_rows.intersect_batch(*bad(A, LA, B, LB))


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions, exactly
# ---------------------------------------------------------------------------

# (n, pa, pb): one chunk, three passes, a long row against a long b
CARD_SHAPES = [(4096, 1, 64), (4096, 8, 1024), (4096, 64, 1024), (1000, 128, 4096),
               (300, 129, 2000), (64, 4096, 65536), (1, 1 << 20, 1 << 20), (2, 1 << 17, 1 << 17)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("kind", chip_smoke.SETOP_KINDS)
@pytest.mark.parametrize("shared", [False, True], ids=["paired", "shared"])
def test_kernel_matches_plain_on_card(card, shared, kind, shape):
    n, pa, pb = shape
    case = _t(chip_smoke.setop_rows_case(n, pa, pb, seed=pa + pb, kind=kind, shared=shared), card)
    for op in ("intersect", "difference"):
        launches = setop_rows.LAUNCHES
        got = getattr(setop_rows, f"{op}_batch")(*case)
        torch.cuda.synchronize()
        assert setop_rows.LAUNCHES == launches + 1
        want = setop_rows.setop_batch_plain(op, *case)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), op
    keep = torch.rand(case[0].shape, generator=torch.Generator(card).manual_seed(pa),
                      device=card) < 0.3
    got = setop_rows.compact_batch(case[0], keep)
    want = setop_rows.compact_batch_plain(case[0], keep)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "max", "lb0"])
def test_member_sweep_shared_b_on_card(card, kind):
    case = _t(chip_smoke.setop_rows_case(5000, 64, 3000, seed=9, kind=kind, shared=True), card)
    launches = member_sweep.LAUNCHES
    got = member_sweep.membership_batch(*case)
    torch.cuda.synchronize()
    assert member_sweep.LAUNCHES == launches + 1
    assert torch.equal(got, member_sweep.membership_batch_plain(*case))


@pytest.mark.cuda
def test_dispatcher_on_card(card):
    """The forced device path over rows across 2^32, on the card
    (chip_smoke's check): the ragged and list forms (K1 with stride 0 and
    setop_rows) and a bucket of pairs (setop_rows paired), each equal to
    numpy; both kernels launched."""
    sweeps, setops_ = member_sweep.LAUNCHES, setop_rows.LAUNCHES
    chip_smoke.dispatcher_across_segments(card)
    assert member_sweep.LAUNCHES > sweeps and setop_rows.LAUNCHES > setops_
