"""Union (K4), k-way merge (K5) and k-way intersection (K6) of sorted
lists, with their stable compaction.

Port of the XLA programs of `dgraph_tpu/ops/setops.py` that the dispatcher
runs for OR filters, AND chains and the @recurse seen-set: `union` (K4),
vmapped over pow2 buckets of segment pairs, and `merge_sorted` (K5) and
`intersect_many` (K6) over a one-segment chain's k lists padded to (k,
pow2). The kernels are `csrc/setop_merge.cu`, written by hand for Hopper;
its head says what bounds them and how they are laid out. Uids travel as
their u32 bits in int32, compared unsigned. Lists are sorted ascending as
uint32 (the reference's precondition) and ragged: X (N,) holds them back
to back, list i at X[offs[i]:offs[i + 1]] (offs int32, offs[0] = 0,
offs[-1] = N), so validity is by index and UINT32_MAX stays a legal uid.

- `union_ragged(X, offs)`: 2m lists, the pairs (a_i, b_i) as lists 2i and
  2i + 1; row i of the result is their union, each value once. Returns
  (out, head): head (m + 1,) is out_off, row i's words are
  out[out_off[i]:out_off[i + 1]] (out has N words; those past out_off[m]
  are not written).
- `merge_sorted(X, offs)`: k lists; their union, each value once, by
  ceil(log2 k) rounds of the pair union (at least one round: a single
  list is deduplicated too), all in one cooperative launch over two
  scratch buffers of the call (`merge_layout`), whatever k is. Returns
  (out, head): head (2,) = (0, count).
- `intersect_many(X, offs)`: k lists; the words of list 0 that every
  other list holds, in list 0's order, with its duplicates. Returns (out,
  head): head (2,) = (0, count).

The plain versions beside them (`union_ragged_plain`, `merge_sorted_plain`,
`intersect_many_plain`, over the port's `setops.union`, `merge_sorted` and
`intersect_many`) are what CPU tensors take; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops import setops
from dgraph_tpu_torch.ops.setop_rows import to_bits, to_u32

UNION_KERNEL = "setop_union_pairs"  # the kernel union_ragged launches
MERGE_KERNEL = "setop_merge_rounds"  # merge_sorted's one launch, every round in it
MANY_KERNEL = "setop_intersect_many"
TILE = 2048  # positions a tile of the kernels takes (checked against the build)
MAX_P = (1 << 31) - 1  # positions are int32 in the kernels

# calls that launched a kernel (each wrapper's own count: a merge_sorted
# call counts once, whatever its rounds), for showing that a path went
# through them; the plain versions' calls on CPU tensors are counted apart
LAUNCHES = {"union_ragged": 0, "merge_sorted": 0, "intersect_many": 0}
PLAIN_CALLS = {"union_ragged": 0, "merge_sorted": 0, "intersect_many": 0}

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built setop_merge library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.setop_union_launch, lib.setop_merge_launch, lib.setop_intersect_many_launch):
        fn.restype = i32
        fn.argtypes = [ptr, ptr, i32, i32, ptr, i32, ptr]
    lib.setop_merge_tile.restype = i32
    lib.setop_merge_tile.argtypes = []
    lib.setop_merge_layout.restype = None
    lib.setop_merge_layout.argtypes = [i32, i32, ptr]
    if lib.setop_merge_tile() != TILE:
        raise RuntimeError(f"setop_merge tile {lib.setop_merge_tile()} != {TILE}")
    got = (ctypes.c_longlong * 4)()
    for k, cap in ((1, 0), (2, 5000), (3, 4096), (256, 256000), (1000, 30001)):
        lib.setop_merge_layout(k, cap, got)
        want = merge_layout(k, cap)
        if list(got) != [want[key] for key in ("words", "zeroed", "out", "head")]:
            raise RuntimeError(f"setop_merge layout at k={k}, cap={cap}: {list(got)} != {want}")
    return lib


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from dgraph_tpu_torch.ops import cuda_build

        _lib = bind(cuda_build.load("setop_merge"))
    return _lib


def rounds(k: int) -> int:
    """Rounds of the pair union that merge k lists: ceil(log2 k), at least 1."""
    return max(1, (k - 1).bit_length())


def kernel_names(name: str) -> dict:
    """The kernel one call of wrapper `name` launches, by name, with its
    launches: one (merge_sorted runs every round inside its one launch)."""
    return {{"union_ragged": UNION_KERNEL, "merge_sorted": MERGE_KERNEL,
             "intersect_many": MANY_KERNEL}[name]: 1}


def merge_layout(k: int, cap: int) -> dict:
    """Where merge_sorted's launch puts each part of its buffer, in int32
    words (`setop_merge_launch` lays it out the same way; `bind` checks):
    each round's status words (2 a tile of cap), the grid barrier's count
    and a pad word, then the offsets of even rounds and of odd rounds
    (ceil(k / 2) + 1 each), which the launch zeroes, then the words of
    even rounds and of odd rounds (cap each, the second only with 2
    rounds or more). Returns {"words": the buffer's size, "zeroed": the
    words zeroed, "out": where the answer's words start, "head": where
    its (0, count) lies}: the last round's, odd or even."""
    tiles, n_rounds, jobs = -(-cap // TILE), rounds(k), (k + 1) // 2
    off = [2 * tiles * n_rounds + 2]
    off.append(off[0] + jobs + 1)
    zeroed = off[1] + jobs + 1
    last = (n_rounds - 1) % 2
    return {"words": zeroed + min(n_rounds, 2) * cap, "zeroed": zeroed,
            "out": zeroed + last * cap, "head": off[last]}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _padded(X, offs, lists):
    """Lists `lists` (an index tensor) of the ragged X as rows (len(lists),
    w) int64 of u32 values padded with UINT32_MAX, and their lengths."""
    lo = offs.to(torch.int64)
    start, lens = lo[lists], lo[lists + 1] - lo[lists]
    w = max(int(lens.max()) if lens.numel() else 0, 1)
    col = torch.arange(w, device=X.device)
    valid = col < lens.unsqueeze(1)
    at = (start.unsqueeze(1) + col).clamp(max=max(X.numel() - 1, 0))
    vals = to_u32(X)[at] if X.numel() else torch.zeros(at.shape, dtype=torch.int64,
                                                     device=X.device)
    return torch.where(valid, vals, setops.UINT32_MAX), lens


def _ragged_out(rows, cnt):
    """Padded result rows and their counts -> (kept words as int32 bits,
    their row offsets (m + 1,) int32)."""
    keep = torch.arange(rows.shape[1], device=rows.device) < cnt.unsqueeze(1)
    off = torch.zeros(cnt.numel() + 1, dtype=torch.int32, device=rows.device)
    off[1:] = torch.cumsum(cnt, 0).to(torch.int32)
    return to_bits(torch.masked_select(rows, keep)), off


def union_ragged_plain(X, offs):
    """Plain PyTorch version of union_ragged: setops.union of each pair,
    rows padded to the longest a and the longest b."""
    m = (offs.numel() - 1) // 2
    idx = torch.arange(m, device=X.device)
    a, la = _padded(X, offs, 2 * idx)
    b, lb = _padded(X, offs, 2 * idx + 1)
    out, cnt = setops.union(a, la, b, lb)
    return _ragged_out(out, cnt)


def merge_sorted_plain(X, offs):
    """Plain PyTorch version of merge_sorted: setops.merge_sorted of the k
    lists padded to the longest."""
    k = offs.numel() - 1
    lists, lens = _padded(X, offs, torch.arange(k, device=X.device))
    out, cnt = setops.merge_sorted(lists, lens)
    return _ragged_out(out.unsqueeze(0), cnt.reshape(1))


def intersect_many_plain(X, offs):
    """Plain PyTorch version of intersect_many: setops.intersect_many of
    the k lists padded to the longest."""
    k = offs.numel() - 1
    lists, lens = _padded(X, offs, torch.arange(k, device=X.device))
    out, cnt = setops.intersect_many(lists, lens)
    return _ragged_out(out.unsqueeze(0), cnt.reshape(1))


PLAIN = {"union_ragged": union_ragged_plain, "merge_sorted": merge_sorted_plain,
         "intersect_many": intersect_many_plain}


# ---------------------------------------------------------------------------
# Checks and the launches
# ---------------------------------------------------------------------------


def _check(name, X, offs, pairs=False):
    if X.dim() != 1 or offs.dim() != 1 or offs.numel() < 2:
        raise ValueError(f"{name}: want X (N,) and offs (n + 1,) with n >= 1, got "
                         f"{tuple(X.shape)}, {tuple(offs.shape)}")
    if pairs and offs.numel() % 2 == 0:
        raise ValueError(f"{name}: want an even number of lists (a, b pairs), got "
                         f"{offs.numel() - 1}")
    for what, t in (("X", X), ("offs", offs)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    if offs.device != X.device:
        raise ValueError(f"{name}: offs is on {offs.device}, X on {X.device}")
    if max(X.numel(), offs.numel()) > MAX_P:
        raise ValueError(f"{name}: more than {MAX_P} positions")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {X.device}")
    if X.device.type == "cuda" and not (X.is_contiguous() and offs.is_contiguous()):
        raise ValueError(f"{name}: X and offs must be contiguous")


def union_ragged(X, offs):
    """Row i of the result: the union of lists 2i and 2i + 1 of X, each
    value once; (out, head) as in the module doc."""
    _check("union_ragged", X, offs, pairs=True)
    if X.device.type == "cpu":
        PLAIN_CALLS["union_ragged"] += 1
        return union_ragged_plain(X, offs)
    LAUNCHES["union_ragged"] += 1
    n, cap = offs.numel() - 1, X.numel()
    tiles, jobs = -(-cap // TILE), n // 2
    buf = torch.empty((2 * tiles + jobs + 2 + cap,), dtype=torch.int32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _kernel().setop_union_launch(X.data_ptr(), offs.data_ptr(), n, cap, buf.data_ptr(),
                                       X.device.index, stream)
    if err:
        raise RuntimeError(f"{UNION_KERNEL} launch failed: cudaError {err}")
    at = 2 * tiles
    return buf[at + jobs + 2 :], buf[at : at + jobs + 1]


def merge_sorted(X, offs):
    """The union of the k lists of X, each value once; (out, head) as in
    the module doc."""
    _check("merge_sorted", X, offs)
    if X.device.type == "cpu":
        PLAIN_CALLS["merge_sorted"] += 1
        return merge_sorted_plain(X, offs)
    LAUNCHES["merge_sorted"] += 1
    k, cap = offs.numel() - 1, X.numel()
    at = merge_layout(k, cap)
    buf = torch.empty((at["words"],), dtype=torch.int32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _kernel().setop_merge_launch(X.data_ptr(), offs.data_ptr(), k, cap, buf.data_ptr(),
                                       X.device.index, stream)
    if err:
        raise RuntimeError(f"{MERGE_KERNEL} launch failed: cudaError {err}")
    return buf[at["out"] : at["out"] + cap], buf[at["head"] : at["head"] + 2]


def intersect_many(X, offs):
    """The words of list 0 of X that lists 1 .. k - 1 all hold, in order;
    (out, head) as in the module doc."""
    _check("intersect_many", X, offs)
    if X.device.type == "cpu":
        PLAIN_CALLS["intersect_many"] += 1
        return intersect_many_plain(X, offs)
    LAUNCHES["intersect_many"] += 1
    cap = X.numel()
    tiles = -(-cap // TILE)
    buf = torch.empty((2 * tiles + 3 + cap,), dtype=torch.int32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = _kernel().setop_intersect_many_launch(X.data_ptr(), offs.data_ptr(), offs.numel() - 1,
                                                cap, buf.data_ptr(), X.device.index, stream)
    if err:
        raise RuntimeError(f"setop_intersect_many launch failed: cudaError {err}")
    at = 2 * tiles
    return buf[at + 3 :], buf[at : at + 2]
