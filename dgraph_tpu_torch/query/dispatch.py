"""Batched set-op dispatcher: the device boundary of the query engine.

Port of `dgraph_tpu/query/dispatch.py` to PyTorch. The SubGraph executor
collects every set operation of a query level and hands the whole batch
to this dispatcher, which:

  1. splits u64 operands into hi-32 segments (codec/uidpack.py) so the
     ops run in the 32-bit local space,
  2. for rows against one shared operand, cuts every row at its
     segments in one pass over the level buffer; each sub-row searches
     the range of the shared operand that holds its segment, all of them
     in one launch over the ragged buffer, b uploaded once;
  3. for pairs, runs intersect and difference sub-jobs in one ragged
     launch with a range of B a pair, union sub-jobs in one ragged launch
     with a and b as adjacent lists, and buckets by padded (pow2) shapes
     the intersect sub-jobs of <= 128 that the member sweep takes
     (ops/member_sweep.py, then setop_rows' compaction); intersect and
     difference run on the hand-written kernel setop_rows
     (ops/setop_rows.py), union on setop_merge (ops/setop_merge.py);
     operands go up in one copy through pinned memory, and the results
     come back as their offsets, then their kept words alone (a bucket:
     in one copy),
  4. for a one-segment AND or OR chain, runs the k-way intersection or
     merge of setop_merge over the k lists staged back to back, and reads
     back the count, then the kept words,
  5. keeps tiny batches on the host (native C++ loops), where moving the
     operands to the card costs more than the work,
  6. row-shards a giant shared operand over the dispatcher's device mesh
     (parallel/mesh.py) when the mesh has more than one device.

The dispatcher is bound to one torch device. `cuda` is the default; the
tests bind `cpu`, where the same batched ops run as CPU tensors. Asking
for CUDA where there is none raises; there is no silent fallback.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgraph_tpu_torch.codec import uidpack
from dgraph_tpu_torch.codec.uidpack import join_segments, split_segments
from dgraph_tpu_torch.device import resolve_device
from dgraph_tpu_torch.ops import member_sweep, packed_setops, setop_merge, setop_rows, setops
from dgraph_tpu_torch.utils.observe import TRACER
from dgraph_tpu_torch.x import config

# Below this much total work, host kernels win. Setting 0 means "always
# use the device"; unset means device-aware auto (_min_total). Read at
# import, like every knob below: tests patch the module attributes.
_env_min_total = config.get("DEVICE_MIN_TOTAL")
_DEVICE_MIN_TOTAL = (
    0 if _env_min_total is None else max(1, int(_env_min_total))
)
# Packed-vs-decode crossover: an array x pack pair takes the
# compressed-domain path (ops/packed_setops.py) when |big| >= ratio *
# |small|; pack x pack pairs bypass the gate when the native block
# engine is in, and the pre-engine cliff (256) re-applies without it.
_PACKED_MIN_RATIO = int(config.get("PACKED_MIN_RATIO"))
_PACKED_FALLBACK_RATIO = 256
# A shared operand of at least this many uids is row-sharded over the
# dispatcher's device mesh (multi-part list data plane) when the mesh
# has more than one device.
_SHARD_MIN_B = int(config.get("SHARD_MIN_B"))
_FORCE_DEVICE = bool(config.get("FORCE_DEVICE"))
# member-sweep kernel for small-side intersect buckets
_USE_PALLAS = bool(config.get("PALLAS"))
_MIN_PAD = 8
# small side of a bucket the member sweep takes (one query per thread)
_SWEEP_MAX_PA = member_sweep.LANE
_HI_SHIFT = np.uint64(32)


def _planner_enabled() -> bool:
    """The cost-based planner's knob (query/planner.py), read here
    without importing the planner."""
    return bool(config.get("QUERY_PLANNER"))


# whether this thread is inside a set op's route span (`_route`)
_IN_ROUTE = threading.local()


@contextmanager
def _route(op: str, host: bool, words: int, min_total: int):
    """The route a set op took, as a span over the branch that runs it:
    `setop_host` or `setop_device`, with the op, the operand words the
    choice weighed, their bytes (u64 ids) and the crossover. The caller
    names the path in the yielded attributes' `route`. Only the
    outermost set op of a thread opens one: the dispatcher's calls to
    itself run inside it and count once."""
    if getattr(_IN_ROUTE, "on", False):
        yield {}
        return
    _IN_ROUTE.on = True
    try:
        with TRACER.span(
            "setop_host" if host else "setop_device", op=op, route="",
            words=int(words), bytes=8 * int(words), min_total=int(min_total),
        ) as sp:
            yield sp.attrs
    finally:
        _IN_ROUTE.on = False


def _pow2(n: int) -> int:
    return max(_MIN_PAD, 1 << (max(1, n) - 1).bit_length())


def _np_op(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # host path: native C++ galloping/merge loops when compiled
    # (dgraph_tpu_torch/native), numpy otherwise
    from dgraph_tpu_torch import native

    if op == "intersect":
        return native.intersect(
            np.asarray(a, np.uint64), np.asarray(b, np.uint64)
        )
    if op == "difference":
        return native.difference(
            np.asarray(a, np.uint64), np.asarray(b, np.uint64)
        )
    if op == "union":
        return native.union(np.asarray(a, np.uint64), np.asarray(b, np.uint64))
    raise ValueError(op)


class DeviceCache:
    """Device-resident operand cache — the card's analog of the
    reference's MemoryLayer (posting/mvcc.go:387).

    Entries are uploaded, padded tensors keyed by the posting lists'
    version identity ((key_bytes, latest_ts) tokens from LocalCache), so
    a hot predicate's list uploads once and every later query level
    reuses the device copy. Commits invalidate by key (mvcc.go:510); a
    version bump also changes the token, so even a missed invalidation
    only costs a re-upload, never staleness. LRU-bounded by bytes."""

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = max_bytes if max_bytes is not None else int(
            config.get("DEVCACHE_BYTES")
        )
        self._lock = threading.Lock()
        # cache token -> (tensors tuple, nbytes)
        self._entries: "OrderedDict[tuple, Tuple[tuple, int]]" = OrderedDict()
        # key bytes -> tokens referencing it (for commit invalidation)
        self._by_key: Dict[bytes, set] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, token: tuple):
        with self._lock:
            got = self._entries.get(token)
            if got is None:
                self.misses += 1
                return None
            self._entries.move_to_end(token)
            self.hits += 1
            return got[0]

    def put(self, token: tuple, keys_involved, arrays: tuple, nbytes: int):
        if nbytes > self.max_bytes:
            return
        with self._lock:
            if token in self._entries:
                return
            self._entries[token] = (arrays, nbytes)
            self._bytes += nbytes
            for k in keys_involved:
                self._by_key.setdefault(k, set()).add(token)
            while self._bytes > self.max_bytes and self._entries:
                old_tok, (_, old_n) = self._entries.popitem(last=False)
                self._bytes -= old_n
                for toks in self._by_key.values():
                    toks.discard(old_tok)

    def invalidate(self, keys) -> None:
        with self._lock:
            for k in keys:
                for tok in self._by_key.pop(k, ()):
                    got = self._entries.pop(tok, None)
                    if got is not None:
                        self._bytes -= got[1]

    def invalidate_prefix(self, prefixes) -> None:
        """Drop cached operands for every key under any prefix (the
        MemoryLayer's tablet-move invalidation, mirrored on the card)."""
        pfx = tuple(bytes(p) for p in prefixes)
        if not pfx:
            return
        with self._lock:
            hit = [
                k for k in self._by_key
                if isinstance(k, (bytes, bytearray)) and bytes(k).startswith(pfx)
            ]
            for k in hit:
                for tok in self._by_key.pop(k, ()):
                    got = self._entries.pop(tok, None)
                    if got is not None:
                        self._bytes -= got[1]

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._by_key.clear()
            self._bytes = 0

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
        }


class PackedOperand:
    """A posting list offered to the dispatcher in compressed (UidPack)
    form. The dispatcher decides per pair — size/selectivity threshold —
    whether to run the compressed-domain block-skip ops on it or to decode
    it once and take the dense path.

    `decode_fn` is the owning PostingList's block-cached partial decoder
    (posting/pl.py decode_blocks) so repeated traversals reuse decoded
    blocks; `uids_fn` is the list's memoized full materializer
    (PostingList.uids), so a dense-pair fallback decodes once per commit
    epoch, not once per query."""

    __slots__ = ("pack", "decode_fn", "uids_fn", "_uids")

    def __init__(self, pack, decode_fn=None, uids=None, uids_fn=None):
        self.pack = pack
        self.decode_fn = decode_fn
        self.uids_fn = uids_fn
        self._uids = uids

    def __len__(self) -> int:
        return self.pack.num_uids

    def decode(self) -> np.ndarray:
        if self._uids is None:
            if self.uids_fn is not None:
                # list-memoized: repeated fallbacks re-use the decode
                self._uids = self.uids_fn()
            else:
                # account the full decode so decode_bytes_per_query
                # reflects the fallback cost too
                packed_setops.COUNTERS.decoded_uids += self.pack.num_uids
                self._uids = uidpack.decode(self.pack)
        return self._uids


def _as_array(x) -> np.ndarray:
    return x.decode() if isinstance(x, PackedOperand) else np.asarray(
        x, np.uint64
    )


def _halves(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The (lo, hi) 32-bit words of a u64 array: views of its little-endian
    words (of the array itself where it is contiguous and little-endian)."""
    words = np.ascontiguousarray(flat, dtype="<u8").view("<u4").reshape(-1, 2)
    return words[:, 0], words[:, 1]


def _stage(dev: torch.device, parts: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """Host arrays of 32-bit words (uid bits, lengths) on `dev`, as int32,
    in one copy: through a pinned block on a card. PyTorch's caching host
    allocator pools the blocks and reuses one only once its copy is done."""
    parts = [np.ascontiguousarray(p).view(np.int32) for p in parts]
    sizes = [p.size for p in parts]
    total = sum(sizes)
    if dev.type != "cuda":
        flat = torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0, np.int32))
        return list(torch.split(flat, sizes))
    buf = torch.empty((total,), dtype=torch.int32, pin_memory=True)
    if total:
        np.concatenate(parts, out=buf.numpy())
    flat = torch.empty((total,), dtype=torch.int32, device=dev)
    flat.copy_(buf, non_blocking=True)
    return list(torch.split(flat, sizes))


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """int32 device tensors back to the host in one copy, as uint32 numpy
    arrays of their shapes, owned by the caller (on a card, views of a
    pinned block of their own)."""
    if len(tensors) == 1:
        flat = tensors[0].reshape(-1)
    else:
        flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.device.type == "cuda":
        buf = torch.empty((flat.numel(),), dtype=torch.int32, pin_memory=True)
        buf.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        host = buf.numpy()
    else:
        host = flat.numpy()
    host = host.view(np.uint32)
    out, at = [], 0
    for t in tensors:
        out.append(host[at : at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _pad_dev(vals: torch.Tensor, lens: torch.Tensor, width: int) -> torch.Tensor:
    """Rows (len(lens), width) int32, padded with UINT32_MAX, from the
    concatenated rows `vals` and their lengths, on their device."""
    n, m = lens.shape[0], vals.shape[0]
    out = torch.full((n, width), -1, dtype=torch.int32, device=vals.device)
    if m:
        lens = lens.to(torch.int64)
        row = torch.repeat_interleave(
            torch.arange(n, device=vals.device), lens, output_size=m
        )
        start = torch.cumsum(lens, 0) - lens
        out[row, torch.arange(m, device=vals.device) - start[row]] = vals
    return out


def _offsets(lens) -> np.ndarray:
    """Row offsets (len(lens) + 1,) int32 of rows of these lengths."""
    off = np.zeros((len(lens) + 1,), np.int32)
    np.cumsum(lens, out=off[1:])
    return off


def _read_back(out, head, rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A ragged result on its device, read back as its row offsets (int64,
    rows + 1) and its words (uint32): `head` (the offsets first, then
    any counters, returned as they are), then the kept words alone."""
    head = _fetch([head])[0]
    res_offs = head[: rows + 1].astype(np.int64)
    total = int(res_offs[-1])
    words = _fetch([out[:total]])[0] if total else np.zeros((0,), np.uint32)
    return res_offs, words, head[rows + 1 :]


def _run_ragged(op, A, offs, rid, B, ranges) -> Tuple[np.ndarray, np.ndarray]:
    """setop_rows over a ragged buffer on its device, read back as the
    result's row offsets (int64, m + 1) and its words (uint32): the
    offsets first, then the kept words alone."""
    out, head = getattr(setop_rows, f"{op}_ragged")(A, offs, rid, B, ranges)
    res_offs, words, tail = _read_back(out, head, offs.numel() - 1)
    setop_rows.GLOBAL_TILES += int(tail[-1])
    return res_offs, words


class SetOpDispatcher:
    """Batches pairwise sorted-set ops onto one torch device."""

    def __init__(self, device="cuda"):
        self.device_cache = DeviceCache()
        self.device = torch.device(device)

    def bind(self, device) -> None:
        """Serve on `device` from now on. The cached operands live on the
        old device, so they go."""
        dev = resolve_device(device)
        if dev != self.device:
            self.device_cache.clear()
        self.device = dev

    def _dev(self) -> torch.device:
        """The device for a device-path op; CUDA must be present."""
        return resolve_device(self.device)

    def packed_min_ratio(self) -> int:
        """big/small size ratio above which an array x pack pair runs
        compressed-domain instead of full-decode + dense kernels (tuned
        crossover 8 with the native adaptive block engine; pack x pack
        pairs skip the gate). Without the engine, candidate blocks decode
        in Python and only selective pairs pay: the pre-engine cliff
        (256) re-applies unless DGRAPH_TPU_PACKED_MIN_RATIO is pinned."""
        if packed_setops.engine_available() or config.is_set(
            "PACKED_MIN_RATIO"
        ):
            return _PACKED_MIN_RATIO
        return max(_PACKED_MIN_RATIO, _PACKED_FALLBACK_RATIO)

    def _try_packed(self, op: str, a, b) -> Optional[np.ndarray]:
        """Run one (a, b) pair compressed-domain when an operand is packed
        and the pair clears the selectivity crossover; None -> caller takes
        the decoded dense path. Fallback candidate spans route back through
        run_pairs, so big spans still reach the device ops.

        Debug-mode queries capture the decision inputs into the EXPLAIN
        plan — see _note_plan_pair."""
        got = self._try_packed_inner(op, a, b)
        self._note_plan_pair(op, a, b, got is not None)
        return got

    def _note_plan_pair(self, op: str, a, b, packed: bool) -> None:
        from dgraph_tpu_torch.utils.observe import current_plan

        plan = current_plan()
        if plan is None:
            return
        a_packed = isinstance(a, PackedOperand)
        b_packed = isinstance(b, PackedOperand)
        plan.note_setop(
            {
                "site": "pair",
                "op": op,
                "a": int(len(a)),
                "b": int(len(b)),
                "a_packed": a_packed,
                "b_packed": b_packed,
                # a packed operand whose decode is memoized takes the
                # dense path regardless of the ratio (sunk cost)
                "decode_sunk": bool(
                    (not a_packed or a._uids is not None)
                    and (not b_packed or b._uids is not None)
                ),
                "min_ratio": int(self.packed_min_ratio()),
                "verdict": "packed" if packed else "decoded",
            }
        )

    def _try_packed_inner(self, op: str, a, b) -> Optional[np.ndarray]:
        if all(
            not isinstance(x, PackedOperand) or x._uids is not None
            for x in (a, b)
        ):
            # every packed operand's full decode is already memoized:
            # the decode cost is sunk, so the dense ops win
            return None
        r = self.packed_min_ratio()
        both = isinstance(a, PackedOperand) and isinstance(b, PackedOperand)
        if op in ("intersect", "difference") and isinstance(b, PackedOperand):
            if (
                both and packed_setops.engine_available()
            ) or len(b) >= r * max(1, len(a)):
                if isinstance(a, PackedOperand):
                    # both packed: intersect forwards both block-cached
                    # decoders; difference needs all of `a` materialized
                    # on the fallback, so without the engine it goes
                    # through the operand's memoized decode
                    if op == "intersect":
                        return packed_setops.intersect_packed(
                            a.pack,
                            b.pack,
                            decode_b=b.decode_fn,
                            runner=self.run_pairs,
                            decode_a=a.decode_fn,
                        )
                    if packed_setops.engine_available():
                        return packed_setops.difference_packed(
                            a.pack,
                            b.pack,
                            decode_b=b.decode_fn,
                            runner=self.run_pairs,
                        )
                    return packed_setops.difference_packed(
                        _as_array(a),
                        b.pack,
                        decode_b=b.decode_fn,
                        runner=self.run_pairs,
                    )
                fn = (
                    packed_setops.intersect_packed
                    if op == "intersect"
                    else packed_setops.difference_packed
                )
                return fn(
                    _as_array(a),
                    b.pack,
                    decode_b=b.decode_fn,
                    runner=self.run_pairs,
                )
        if op == "intersect" and isinstance(a, PackedOperand):
            if len(a) >= r * max(1, len(b)):
                return packed_setops.intersect_packed(
                    _as_array(b),
                    a.pack,
                    decode_b=a.decode_fn,
                    runner=self.run_pairs,
                )
        return None

    def _min_total(self) -> int:
        """Total work below which an op stays on the host: the env
        override first; a CPU-bound dispatcher keeps everything on the
        native host loops (the batched torch ops on the CPU never beat
        them); on CUDA the reference's 1 << 15 stands until a capture on
        the card sets it."""
        if _DEVICE_MIN_TOTAL:
            return _DEVICE_MIN_TOTAL
        if self.device.type == "cpu":
            return 1 << 62
        return 1 << 15

    def _host(self, total: int) -> bool:
        return not _FORCE_DEVICE and total < self._min_total()

    # -- shared-big-operand fan-out -----------------------------------------

    def run_rows_vs_one(
        self,
        op: str,
        rows: Sequence[np.ndarray],
        b: np.ndarray,
        row_tokens: Optional[Sequence[Optional[tuple]]] = None,
        b_token: Optional[tuple] = None,
    ) -> List[np.ndarray]:
        """Apply `op` to each (row, b) with ONE shared b operand — the
        dominant query shape (uid_matrix rows vs a filter result, recurse
        frontier vs seen-set). b uploads once per call instead of being
        replicated per pair.

        `row_tokens` / `b_token` are (key, latest_ts) posting-list version
        identities; when present, the device uploads are cached in the
        DeviceCache and reused across calls/queries until a commit
        invalidates the key.

        Small work stays on the host. On the device, intersect and
        difference run every row's sub-rows against b's segments in one
        launch (`_vs_one_device`); union goes to the pair path."""
        rows = list(rows)
        if not rows:
            return []
        total = sum(len(r) for r in rows) + len(b)
        host = self._host(total)
        with _route(op, host, total, self._min_total()) as attrs:
            if host:
                if op in ("intersect", "difference") and len(rows) > 4:
                    # vectorized host path: ONE searchsorted over the
                    # concatenated rows beats per-row native calls (ctypes
                    # marshaling dominates at small sizes)
                    attrs["route"] = "host_vectorised"
                    b64 = np.asarray(b, np.uint64)
                    cat = np.concatenate(
                        [np.asarray(r, np.uint64) for r in rows]
                    )
                    if len(b64) and len(cat):
                        idx = np.searchsorted(b64, cat)
                        idx_c = np.minimum(idx, len(b64) - 1)
                        mask = b64[idx_c] == cat
                    else:
                        mask = np.zeros(len(cat), bool)
                    if op == "difference":
                        mask = ~mask
                    out = []
                    off = 0
                    for r in rows:
                        n = len(r)
                        out.append(cat[off : off + n][mask[off : off + n]])
                        off += n
                    return out
                attrs["route"] = "host_native"
                return [_np_op(op, r, b) for r in rows]
            if op in ("intersect", "difference") and self._shard_gate(b):
                attrs["route"] = "sharded"
                got = self._run_rows_sharded(op, rows, b, b_token)
                if got is not None:
                    return got
            if op == "union":
                attrs["route"] = "pairs"
                return self.run_pairs(op, [(r, b) for r in rows])
            from dgraph_tpu_torch.query import ragged

            attrs["route"] = "rows"
            flat, offs = ragged.pack_rows([np.asarray(r, np.uint64) for r in rows])
            res, res_offs = self._vs_one_device(
                op, flat, offs, np.asarray(b, np.uint64), row_tokens, b_token
            )
            return ragged.row_views(res, res_offs)

    def _shard_gate(self, b) -> bool:
        """Whether a shared operand is giant enough to row-shard over the
        dispatcher's mesh (and the mesh has more than one device)."""
        return len(b) >= _SHARD_MIN_B and self._mesh().size > 1

    def _vs_one_device(self, op, flat, offs, b, row_tokens=None, b_token=None):
        """op(row, b) for intersect or difference of every row of a ragged
        level buffer (`flat`, `offs`) against one shared sorted b, on the
        device, in one setop_rows launch; returns the result as (flat,
        offs).

        The hi-32 segments are cut once, over the whole buffer: a sub-row
        is a run of one row within one segment, and searches the range of
        b's lo words that holds b's segment of its hi word, or an empty
        range where b has none (intersect then keeps none of it,
        difference all). The sub-rows' lo words, starts and range ids go
        up in one copy; b's lo words and its range table go up once (or
        come from the DeviceCache under ("b", b_token, len(b))); with
        every row's token given and one segment in all, the sub-rows are
        cached too, under ("rows", hi, row_tokens). The result comes back
        as its offsets, then its kept words alone; rows stay sorted since
        each row's sub-rows run in hi order."""
        n = len(offs) - 1
        N = flat.size
        if not N:
            return flat, offs
        lo, hi = _halves(flat)
        # a sub-row starts where a row starts or the hi word changes
        cut = np.zeros((N,), bool)
        cut[offs[:-1][np.diff(offs) > 0]] = True
        cut[1:] |= hi[1:] != hi[:-1]
        starts = np.flatnonzero(cut)
        sub_hi = hi[starts]
        b_lo, b_hi = _halves(b)
        b_his, b_at, b_n = np.unique(b_hi, return_index=True, return_counts=True)
        # range k holds b's segment b_his[k]; the last range is empty
        k = np.minimum(np.searchsorted(b_his, sub_hi), max(len(b_his) - 1, 0))
        found = b_his[k] == sub_hi if len(b_his) else np.zeros(len(sub_hi), bool)
        rid = np.where(found, k, len(b_his)).astype(np.int32)
        # sub-rows are cached only where the reference caches its rows: all
        # rows and b in one segment. The tokens name no store, so a wider
        # cache could serve another store's rows where the reference reads
        # its own (ROADMAP Queue 3 C)
        stack = (
            row_tokens is not None and len(row_tokens) == n
            and all(t is not None for t in row_tokens)
            and len(set(np.unique(sub_hi).tolist()) | set(b_his.tolist())) == 1
        )
        rows_key = ("rows", int(sub_hi[0]), tuple(row_tokens)) if stack else None
        b_key = None if b_token is None else ("b", b_token, len(b))
        rows = rows_key and self.device_cache.get(rows_key)
        bt = b_key and self.device_cache.get(b_key)
        parts = []
        if not rows:
            parts += [lo, np.append(starts, N).astype(np.int32), rid]
        if not bt:
            table = np.zeros((len(b_his) + 1, 2), np.int32)
            table[:-1, 0], table[:-1, 1] = b_at, b_n
            parts += [b_lo, table.ravel()]
        staged = iter(_stage(self._dev(), parts))
        # what is cached is cloned out of the one upload, which it would
        # otherwise keep alive
        if not rows:
            rows = tuple(next(staged) for _ in range(3))
            if rows_key:
                rows = tuple(t.clone() for t in rows)
                self.device_cache.put(rows_key, [t[0] for t in row_tokens], rows,
                                      4 * sum(t.numel() for t in rows))
        if not bt:
            bt = (next(staged), next(staged).view(-1, 2))
            if b_key:
                bt = tuple(t.clone() for t in bt)
                self.device_cache.put(b_key, [b_token[0]], bt, 4 * sum(t.numel() for t in bt))
        sub_offs, words = _run_ragged(op, *rows, *bt)
        kept = np.diff(sub_offs)
        res = (np.repeat(sub_hi.astype(np.uint64), kept) << _HI_SHIFT) | words
        res_offs = np.zeros((n + 1,), np.int64)
        sub_row = np.searchsorted(offs, starts, side="right") - 1
        np.cumsum(np.bincount(sub_row, weights=kept, minlength=n).astype(np.int64),
                  out=res_offs[1:])
        return res, res_offs

    def _mesh(self):
        """The dispatcher's device mesh (parallel/mesh.py), on its device."""
        from dgraph_tpu_torch.parallel import mesh as pmesh

        return pmesh.make_mesh(device=self.device)

    def _run_rows_sharded(self, op, rows, b, b_token):
        """Row-shard the giant shared operand over the device mesh and
        OR-reduce per-row membership masks (the multi-part list data
        plane). Returns None when shapes don't qualify (caller falls
        through to the single-device path)."""
        from dgraph_tpu_torch.parallel import mesh as pmesh

        b64 = np.asarray(b, np.uint64)
        bseg = split_segments(b64)
        row_segs = [split_segments(np.asarray(r, np.uint64)) for r in rows]
        his = set(bseg)
        for rs in row_segs:
            his |= set(rs)
        if len(his) != 1:
            return None
        hi = next(iter(his))
        b32 = bseg[hi]
        mesh = self._mesh()
        ndev = mesh.size

        Bd = None
        tile = -(-len(b32) // ndev)
        tile = max(_MIN_PAD, 1 << (tile - 1).bit_length())
        pb = tile * ndev
        if b_token is not None:
            cached = self.device_cache.get(("bshard", b_token, hi, pb))
            if cached is not None:
                Bd = cached[0]
        if Bd is None:
            Bd = pmesh.shard(mesh, setops.pad_sorted(b32, pb))
            if b_token is not None:
                self.device_cache.put(
                    ("bshard", b_token, hi, pb), [b_token[0]], (Bd,), pb * 8
                )

        n = len(rows)
        pa = _pow2(max((len(rs.get(hi, ())) for rs in row_segs), default=1))
        A = np.full((n, pa), setops.UINT32_MAX, np.uint32)
        LA = np.zeros((n,), np.int32)
        for i, rs in enumerate(row_segs):
            r32 = rs.get(hi, np.zeros((0,), np.uint32))
            A[i, : len(r32)] = r32
            LA[i] = len(r32)
        mask = (
            pmesh.sharded_rows_membership(
                mesh, setops.to_device(A, mesh.devices[0]), LA, Bd, len(b32)
            )
            .cpu()
            .numpy()
        )
        out = []
        for i in range(n):
            row = A[i, : LA[i]]
            m = mask[i, : LA[i]]
            kept = row[m] if op == "intersect" else row[~m]
            out.append(join_segments({hi: kept}))
        return out

    def run_rows_vs_one_ragged(
        self,
        op: str,
        flat: np.ndarray,
        offs: np.ndarray,
        b: np.ndarray,
        row_tokens: Optional[Sequence[Optional[tuple]]] = None,
        b_token: Optional[tuple] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """run_rows_vs_one over a ragged level buffer: rows live in ONE
        flat sorted-per-row u64 array with prefix `offs` (level-batched
        task form, query/ragged.py). Returns the result in the same
        (flat, offs) shape without materializing per-row lists.

        The host path is fully vectorized — one searchsorted over the
        whole flat buffer plus one cumsum to rebuild offsets. The device
        path for intersect and difference (`_vs_one_device`) cuts the
        buffer at its segments in one pass and never forms a list of
        rows."""
        from dgraph_tpu_torch.query import ragged

        n = len(offs) - 1
        b64 = np.asarray(b, np.uint64)
        if n == 0:
            return flat, offs
        if not flat.size and op != "union":
            return flat, offs  # all rows empty: intersect/difference stay so
        if op == "intersect" and not b64.size:
            return np.zeros((0,), np.uint64), np.zeros_like(offs)
        if op in ("difference", "union") and not b64.size:
            return flat, offs
        total = flat.size + b64.size
        host = self._host(total)
        if host and op in ("intersect", "difference") and flat.size:
            with _route(op, True, total, self._min_total()) as attrs:
                attrs["route"] = "host_vectorised"
                idx = np.minimum(
                    np.searchsorted(b64, flat), b64.size - 1
                )
                mask = b64[idx] == flat
                if op == "difference":
                    mask = ~mask
                return ragged.apply_mask(flat, offs, mask)
        if op in ("intersect", "difference") and not self._shard_gate(b64):
            with _route(op, host, total, self._min_total()) as attrs:
                attrs["route"] = "rows"
                return self._vs_one_device(
                    op, np.asarray(flat, np.uint64), offs, b64, row_tokens, b_token
                )
        rows = [flat[offs[i] : offs[i + 1]] for i in range(n)]
        res = self.run_rows_vs_one(
            op, rows, b64, row_tokens=row_tokens, b_token=b_token
        )
        out_offs = np.zeros((n + 1,), np.int64)
        np.cumsum([len(r) for r in res], out=out_offs[1:])
        if not out_offs[-1]:
            return np.zeros((0,), np.uint64), out_offs
        return (
            np.concatenate(res).astype(np.uint64, copy=False),
            out_offs,
        )

    def run_chain(self, op: str, parts: Sequence[np.ndarray]) -> np.ndarray:
        """Combine k sorted u64 sets with one associative op (AND/OR filter
        chains, ref query.go:2355-2372) in a single device dispatch instead
        of k-1 sequential pairwise calls.

        Operands may be PackedOperand (compressed posting lists): intersect
        chains fold packed operands compressed-domain when the pair clears
        the packed crossover; everything else decodes once up front."""
        if any(isinstance(p, PackedOperand) for p in parts):
            if op == "intersect":
                return self._run_chain_packed_intersect(list(parts))
            parts = [_as_array(p) for p in parts]
        parts = [np.asarray(p, np.uint64) for p in parts]
        if not parts:
            return np.zeros((0,), np.uint64)
        if len(parts) == 1:
            return parts[0]
        if op == "intersect" and any(len(p) == 0 for p in parts):
            return np.zeros((0,), np.uint64)
        if op == "intersect" and len(parts) > 2 and _planner_enabled():
            # planner hook (query/planner.py): fold smallest-first so the
            # pairwise host chain's running result collapses early —
            # a pure execution-order choice
            parts = sorted(parts, key=len)
        total = sum(len(p) for p in parts)
        if op == "union" and len(parts) > 256:
            # k-way union of MANY small rows: one host unique beats both
            # the pairwise loop and a device merge whose padding is mostly
            # air (the uid_in reverse fan-out shape)
            with _route(op, True, total, self._min_total()) as attrs:
                attrs["route"] = "host_vectorised"
                return np.unique(np.concatenate(parts))
        host = self._host(total)
        with _route(op, host, total, self._min_total()) as attrs:
            if host:
                if op == "union" and len(parts) > 4:
                    attrs["route"] = "host_vectorised"
                    return np.unique(np.concatenate(parts))
                attrs["route"] = "host_native"
                out = parts[0]
                for p in parts[1:]:
                    out = _np_op(op, out, p)
                return out
            segs = [split_segments(p) for p in parts]
            his = set()
            for s in segs:
                his |= set(s)
            if len(his) > 1:
                attrs["route"] = "pairs"
                out = parts[0]
                for p in parts[1:]:
                    out = self.run_pairs(op, [(out, p)])[0]
                return out
            attrs["route"] = "chain"
            hi = next(iter(his)) if his else 0
            arrs = [s.get(hi, np.zeros((0,), np.uint32)) for s in segs]
            # the k lists back to back in one copy; the count comes back,
            # then the kept words alone
            X, offs = _stage(self._dev(), [
                np.concatenate(arrs), _offsets(np.fromiter(map(len, arrs), np.int64, len(arrs))),
            ])
            fn = setop_merge.intersect_many if op == "intersect" else setop_merge.merge_sorted
            _, words, _ = _read_back(*fn(X, offs), 1)
            return join_segments({hi: words})

    def _run_chain_packed_intersect(self, parts: List) -> np.ndarray:
        """Intersect chain with packed operands: fold from the smallest
        operand outward. Each packed operand either stays compressed (the
        running result is small enough that block-skip pays — the common
        shape: tiny frontier vs huge index lists) or decodes once and joins
        the dense chain."""
        if not parts:
            return np.zeros((0,), np.uint64)
        if any(len(p) == 0 for p in parts):
            return np.zeros((0,), np.uint64)
        r = self.packed_min_ratio()
        parts = sorted(parts, key=len)
        cur = _as_array(parts[0])
        dense: List[np.ndarray] = []
        for p in parts[1:]:
            if (
                isinstance(p, PackedOperand)
                and p._uids is None  # decode not already sunk
                and len(p) >= r * max(1, len(cur))
            ):
                cur = packed_setops.intersect_packed(
                    cur, p.pack, decode_b=p.decode_fn, runner=self.run_pairs
                )
                if len(cur) == 0:
                    return cur
            else:
                dense.append(_as_array(p))
        if not dense:
            return cur
        return self.run_chain("intersect", [cur] + dense)

    # -- public API ---------------------------------------------------------

    def run_pairs(
        self, op: str, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
    ) -> List[np.ndarray]:
        """Apply `op` to each (a, b) pair of sorted u64 arrays (either side
        may be a PackedOperand; qualifying pairs run compressed-domain,
        the rest decode and batch as before).

        Returns sorted u64 result arrays, one per pair.
        """
        if not pairs:
            return []
        out: List[Optional[np.ndarray]] = [None] * len(pairs)
        dense: List[Tuple[np.ndarray, np.ndarray]] = []
        dense_at: List[int] = []
        for i, (a, b) in enumerate(pairs):
            if isinstance(a, PackedOperand) or isinstance(b, PackedOperand):
                got = self._try_packed(op, a, b)
                if got is not None:
                    out[i] = got
                    continue
                a, b = _as_array(a), _as_array(b)
            dense.append((a, b))
            dense_at.append(i)
        # kernel-choice accounting (packed vs decoded) for the per-query
        # profile and the cluster metrics endpoint
        from dgraph_tpu_torch.utils.observe import METRICS

        METRICS.inc("setop_pairs_total", len(pairs))
        if len(dense) < len(pairs):
            METRICS.inc("setop_packed_total", len(pairs) - len(dense))
        if dense:
            total = sum(len(a) + len(b) for a, b in dense)
            host = self._host(total)
            with _route(op, host, total, self._min_total()) as attrs:
                if host:
                    attrs["route"] = "host_native"
                    got = [_np_op(op, a, b) for a, b in dense]
                else:
                    attrs["route"] = "pairs"
                    got = self._run_pairs_device(op, dense)
            for i, res in zip(dense_at, got):
                out[i] = res
        return out

    def intersect_pairs(self, pairs):
        return self.run_pairs("intersect", pairs)

    def union_pairs(self, pairs):
        return self.run_pairs("union", pairs)

    def difference_pairs(self, pairs):
        return self.run_pairs("difference", pairs)

    # -- device path --------------------------------------------------------

    def _run_pairs_device(self, op, pairs):
        # Explode u64 pairs into u32 segment sub-jobs.
        sub: List[Tuple[int, int, np.ndarray, np.ndarray]] = []  # (pair, hi, a, b)
        passthrough: List[Tuple[int, int, np.ndarray]] = []  # (pair, hi, lo)
        for pi, (a, b) in enumerate(pairs):
            sa = split_segments(np.asarray(a, np.uint64))
            sb = split_segments(np.asarray(b, np.uint64))
            his = set(sa) | set(sb)
            for hi in his:
                la, lb = sa.get(hi), sb.get(hi)
                if la is not None and lb is not None:
                    sub.append((pi, hi, la, lb))
                elif la is not None and op in ("union", "difference"):
                    passthrough.append((pi, hi, la))
                elif lb is not None and op == "union":
                    passthrough.append((pi, hi, lb))

        # The member sweep's intersect sub-jobs run a bucket of padded
        # (pow2) shapes at a time; every other sub-job runs in one ragged
        # launch (setop_rows, or setop_merge's union).
        buckets: Dict[Tuple[int, int], List[int]] = {}
        ragged: List[int] = []
        for i, (_, _, a, b) in enumerate(sub):
            pa = _pow2(len(a))
            if self._sweeps(op, pa):
                buckets.setdefault((pa, _pow2(len(b))), []).append(i)
            else:
                ragged.append(i)

        # Regroup per pair in one pass. A (pair, hi) key lands either in a
        # device sub-job (segment present in both operands) or in
        # passthrough (present in exactly one) — never both.
        by_pair: List[Dict[int, np.ndarray]] = [dict() for _ in pairs]
        runs = [(idxs, self._run_bucket(pa, pb, [sub[i] for i in idxs]))
                for (pa, pb), idxs in buckets.items()]
        if ragged:
            jobs = [sub[i] for i in ragged]
            runs.append((ragged, self._run_union_ragged(jobs) if op == "union"
                          else self._run_pairs_ragged(op, jobs)))
        for idxs, outs in runs:
            for (pi, hi, _, _), res in zip((sub[i] for i in idxs), outs):
                by_pair[pi][hi] = res
        for pi, hi, lo in passthrough:
            by_pair[pi][hi] = lo
        return [join_segments(segs) for segs in by_pair]

    def _sweeps(self, op: str, pa: int) -> bool:
        """Intersect buckets whose small side fits one CTA go through the
        member-sweep kernel (the reference's Pallas branch)."""
        return _USE_PALLAS and op == "intersect" and pa <= _SWEEP_MAX_PA

    def _run_bucket(self, pa, pb, jobs):
        """The intersect of the (pair, hi, a, b) sub-jobs of a bucket on the
        member sweep (K1) and its compaction: the rows go up in one copy,
        are padded to (n, pa) and (n, pb) on the device, and come back in
        one copy."""
        n = len(jobs)
        dev = self._dev()
        a_vals, a_lens, b_vals, b_lens = _stage(dev, [
            np.concatenate([j[2] for j in jobs]),
            np.fromiter((len(j[2]) for j in jobs), np.int32, n),
            np.concatenate([j[3] for j in jobs]),
            np.fromiter((len(j[3]) for j in jobs), np.int32, n),
        ])
        A, B = _pad_dev(a_vals, a_lens, pa), _pad_dev(b_vals, b_lens, pb)
        out, cnt = _fetch(list(member_sweep.intersect_batch(A, a_lens, B, b_lens)))
        return [out[i, : cnt[i]].copy() for i in range(n)]

    def _run_pairs_ragged(self, op, jobs):
        """Intersect or difference of the (pair, hi, a, b) sub-jobs in one
        setop_rows launch: the a's back to back as the rows, the b's back
        to back as B with one range a sub-job; all of it goes up in one
        copy, and the kept words come back alone."""
        n = len(jobs)
        a_len = np.fromiter((len(j[2]) for j in jobs), np.int64, n)
        b_len = np.fromiter((len(j[3]) for j in jobs), np.int64, n)
        table = np.stack([_offsets(b_len)[:-1], b_len], axis=1).astype(np.int32)
        A, offs, rid, B, ranges = _stage(self._dev(), [
            np.concatenate([j[2] for j in jobs]), _offsets(a_len),
            np.arange(n, dtype=np.int32), np.concatenate([j[3] for j in jobs]), table.ravel(),
        ])
        res_offs, words = _run_ragged(op, A, offs, rid, B, ranges.view(-1, 2))
        return [words[res_offs[i] : res_offs[i + 1]] for i in range(n)]

    def _run_union_ragged(self, jobs):
        """Union of the (pair, hi, a, b) sub-jobs in one setop_merge launch:
        a_i and b_i as lists 2i and 2i + 1 of one buffer, which goes up in
        one copy with its offsets; the result's offsets come back, then
        its kept words alone."""
        n = len(jobs)
        lens = np.fromiter((len(x) for j in jobs for x in j[2:]), np.int64, 2 * n)
        X, offs = _stage(self._dev(), [
            np.concatenate([x for j in jobs for x in j[2:]]), _offsets(lens),
        ])
        res_offs, words, _ = _read_back(*setop_merge.union_ragged(X, offs), n)
        return [words[res_offs[i] : res_offs[i + 1]] for i in range(n)]


# Module-level singleton used by the executor. Bound to CUDA by default;
# nothing touches the card until a device-path op runs (Server binds it).
DISPATCHER = SetOpDispatcher()
