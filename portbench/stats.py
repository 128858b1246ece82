"""The benchmark's frozen arithmetic: percentiles, rates and spreads.

Later changes to the program are measured with these functions, so they
live here and are not edited.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it. A failed read is passed
    as +inf, so it ranks above every answered one."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(count: int, seconds: float) -> float:
    """Events per second over a window."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def mean(values: Sequence[float]) -> float:
    if not values:
        raise ValueError("mean of no values")
    return math.fsum(values) / len(values)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median, by `statistics.quantiles(values, n=4)` (its exclusive
    method), as the bounds in BENCHMARK.json are set from it."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals: List[tuple]) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once."""
    total = 0.0
    end = -math.inf
    start = None
    for s, e in sorted(intervals):
        if s > end:
            if start is not None:
                total += end - start
            start, end = s, e
        elif e > end:
            end = e
    if start is not None:
        total += end - start
    return total


def merged(intervals: List[tuple]) -> List[tuple]:
    """(start, end) intervals merged where they overlap, in order."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
