"""One run of one cell: set-up, the measured window, the readings, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
in a file of its own, found by the name BENCHMARK.json gives it:

- a configuration is `configs/<name>.json`; its `system` key names the
  module `systems/<system>.py` that makes its data from the seed and
  loads it into the port;
- a traffic mix is `traffic/<name>.json`: the clients, the reads
  prepared, the warm-up, the sample checked, and a `mix` of read kinds
  with their shares and parameters; each kind is `reads/<read>.py`,
  which makes a read's text and holds the reference that judges it;
- a metric is `metrics/<name>.py`, with `read(ctx)` and, where it must
  look before the window, `start(ctx)`.

The loop is closed: each client thread sends its next read when the
previous answer has come back, through `Server.query` on the one
server, until the window closes; the reads in flight then finish, and
their latencies count.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import resource
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from portbench import isolation
from portbench.seeds import rng as seeded

_MODULES: Dict[str, object] = {}


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_module(root: str, rel: str):
    """The module in file `rel` under the checkout's root, loaded by path
    (the names of configurations and metrics may hold `-` and `.`)."""
    path = os.path.join(root, rel)
    if path not in _MODULES:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{rel} is not in the checkout")
        name = "portbench._found." + rel[:-3].replace("/", "_").replace("-", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic and
    metrics, all found by name."""

    def __init__(self, spec: dict, name: str, root: str, bench_dir: str = "portbench"):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        self.name = name
        self.root = root
        self.dir = bench_dir
        self.chips = int(w["chips"])
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        self.config = load_json(root, conf["file"])
        self.traffic_name = w["traffic"]
        self.traffic = load_json(root, f"{bench_dir}/traffic/{w['traffic']}.json")

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]

    def system(self):
        return load_module(self.root, f"{self.dir}/systems/{self.config['system']}.py")

    def read_kind(self, read: str):
        return load_module(self.root, f"{self.dir}/reads/{read}.py")

    def metric(self, name: str):
        return load_module(self.root, f"{self.dir}/metrics/{name}.py")


class Item:
    __slots__ = ("kind", "text", "arg")

    def __init__(self, kind: int, text: str, arg):
        self.kind, self.text, self.arg = kind, text, arg


class Record:
    """One read sent in the window."""

    __slots__ = ("client", "item", "sent", "done", "raw", "latency", "kernel", "error")

    def __init__(self, client, item, sent, done, raw=None, latency=None, kernel=None, error=None):
        self.client, self.item, self.sent, self.done = client, item, sent, done
        self.raw, self.latency, self.kernel, self.error = raw, latency, kernel, error


class Ctx:
    """What a metric reads: the cell, the program's state, every read of
    the window, the window's clocks, and the card's trace in a traced
    run. `store` holds what a metric's `start` keeps for its `read`."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.state = None
        self.data = None
        self.items: List[Item] = []
        self.kinds: List[dict] = []
        self.records: List[Record] = []
        self.window_start = 0.0
        self.deadline = 0.0
        self.setup_s = 0.0
        self.cpu_s = 0.0
        self.devtrace = None
        self.store: dict = {}

    @property
    def server(self):
        return self.state.server

    def kind_of(self, rec: Record) -> str:
        return self.kinds[self.items[rec.item].kind]["read"]

    def answered_in_window(self) -> int:
        return sum(1 for r in self.records if r.error is None and r.done <= self.deadline)

    def latencies_ms(self) -> List[float]:
        """Each read's latency at the client, a failed read as +inf."""
        return [math.inf if r.error is not None else (r.done - r.sent) * 1e3 for r in self.records]

    def server_latency_ms(self, key: str) -> List[float]:
        return [r.latency[key] / 1e6 for r in self.records if r.latency and key in r.latency]


def prepare(cell: Cell, ctx: Ctx, data) -> None:
    """Every read's text, made before the window: `pool` reads for the
    window and `warmup_per_client` a client for the warm-up, split over
    the mix's kinds by share and interleaved in a seeded order."""
    t = cell.traffic
    clients = int(t["clients"])
    total = int(t["pool"]) + clients * int(t["warmup_per_client"])
    shares = [float(k["share"]) for k in t["mix"]]
    counts = [int(total * s / sum(shares)) for s in shares]
    counts[0] += total - sum(counts)
    items: List[Item] = []
    for ki, (kind, count) in enumerate(zip(t["mix"], counts)):
        mod = cell.read_kind(kind["read"])
        for text, arg in mod.prepare(data, kind, ctx.seed, count):
            items.append(Item(ki, text, arg))
    order = seeded(ctx.seed, "order").permutation(len(items))
    ctx.items = [items[i] for i in order]
    ctx.kinds = list(t["mix"])


def _ask(server, item: Item, client: int, traced: bool, label: str) -> Record:
    sent = time.perf_counter()
    try:
        if traced:
            import torch

            with torch.profiler.record_function(label):
                r = server.query(item.text, want="raw")
        else:
            r = server.query(item.text, want="raw")
        done = time.perf_counter()
        ext = r.get("extensions") or {}
        prof = ext.get("profile") or {}
        return Record(client, None, sent, done, r["data"].raw, ext.get("server_latency"),
                      prof.get("kernel"))
    except Exception as e:  # noqa: BLE001 - a failed read is counted, not raised
        return Record(client, None, sent, time.perf_counter(), error=f"{type(e).__name__}: {e}")


def warm_up(ctx: Ctx, clients: int, per_client: int) -> None:
    """The first read of each kind alone (it builds the device state and
    the kernels), then every client's warm-up reads at once, as the
    window will send them."""
    server = ctx.server
    warm = ctx.items[len(ctx.items) - clients * per_client:]
    seen = set()
    for it in warm:
        if it.kind not in seen:
            seen.add(it.kind)
            rec = _ask(server, it, -1, False, "")
            if rec.error:
                raise RuntimeError(f"warm-up read failed: {rec.error}")
    errors = []

    def run(c):
        for it in warm[c::clients]:
            rec = _ask(server, it, c, False, "")
            if rec.error:
                errors.append(rec.error)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError(f"{len(errors)} warm-up reads failed, the first: {errors[0]}")


class _GcClock:
    """The interpreter's garbage collections while it runs, by generation:
    how many and their seconds (a diagnostic line in the run's log)."""

    def __init__(self):
        self.t = {}
        self.by_gen = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        g = info.get("generation", 0)
        if phase == "start":
            self.t[g] = time.perf_counter()
        elif g in self.t:
            self.by_gen[g][0] += 1
            self.by_gen[g][1] += time.perf_counter() - self.t.pop(g)

    def stop(self):
        if self in gc.callbacks:
            gc.callbacks.remove(self)

    def summary(self) -> str:
        return ", ".join(f"gen{g} {n} in {s:.3f} s" for g, (n, s) in self.by_gen.items())


def _host_times():
    """(this process's CPU seconds, the machine's CPU jiffies from
    /proc/stat: busy, steal, all), or None for the machine's where the
    file cannot be read."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    own = ru.ru_utime + ru.ru_stime
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return own, None
    idle = v[3] + v[4]
    return own, (sum(v) - idle - v[7], v[7], sum(v))


def _host_quarter(a, b, seconds: float) -> str:
    """Cores this process used, and the machine's busy and stolen shares
    of its CPU time, between two `_host_times` readings."""
    line = f"{(b[0] - a[0]) / seconds:.2f} cores own"
    if a[1] is not None and b[1] is not None:
        d = [y - x for x, y in zip(a[1], b[1])]
        if d[2] > 0:
            line += f", machine busy {d[0] / d[2]:.3f} steal {d[1] / d[2]:.3f}"
    return line


def window(ctx: Ctx, clients: int, t_start: float) -> None:
    """The measured window: `clients` threads in a closed loop over their
    share of the pool, sending until the deadline."""
    server = ctx.server
    pool = len(ctx.items) - clients * int(ctx.cell.traffic["warmup_per_client"])
    mine = [list(range(c, pool, clients)) for c in range(clients)]
    labels = [f"read:{k['read']}" for k in ctx.kinds]
    gate = threading.Barrier(clients + 1)
    out: List[List[Record]] = [[] for _ in range(clients)]
    wrapped = [False] * clients

    def client(c):
        recs, todo = out[c], mine[c]
        gate.wait()
        j = 0
        while time.perf_counter() < ctx.deadline:
            if j == len(todo):
                wrapped[c] = True
            i = todo[j % len(todo)]
            j += 1
            it = ctx.items[i]
            rec = _ask(server, it, c, ctx.trace, labels[it.kind])
            rec.item = i
            recs.append(rec)

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for th in threads:
        th.start()
    # every window starts from the same collector state: the set-up's
    # garbage collected, the generations' counts at zero, so windows of
    # one length meet the same number of full collections
    gc.collect()
    gcs = _GcClock()
    ctx.setup_s = time.time() - t_start
    ru = resource.getrusage(resource.RUSAGE_SELF)
    ctx.window_start = time.perf_counter()
    ctx.deadline = ctx.window_start + ctx.seconds
    gate.wait()
    # the host in each quarter: a slow quarter with the machine busy or
    # stolen from is the host's, one with this process alone is the program's
    q = ctx.seconds / 4
    host = [_host_times()]
    for i in range(1, 5):
        time.sleep(max(0.0, ctx.window_start + i * q - time.perf_counter()))
        host.append(_host_times())
    for th in threads:
        th.join(timeout=ctx.seconds + 600)
        if th.is_alive():
            raise RuntimeError("a client did not finish within 600 s of the window's end")
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    ctx.cpu_s = (ru1.ru_utime - ru.ru_utime) + (ru1.ru_stime - ru.ru_stime)
    gcs.stop()
    log(f"garbage collections in the window: {gcs.summary()}")
    ctx.records = sorted((r for recs in out for r in recs), key=lambda r: r.sent)
    if any(wrapped):
        log(f"the pool of {pool} reads ran out: {sum(wrapped)} clients sent reads again")
    log("by quarter of the window: " + "; ".join(
        f"{n} answered, {ms:.1f} ms mean latency of those sent" for n, ms in quarters(ctx)))
    log(f"host by quarter ({os.cpu_count()} CPUs, {clients} clients): " + "; ".join(
        _host_quarter(host[i], host[i + 1], q) for i in range(4)))


def quarters(ctx: Ctx) -> list:
    """(reads answered, mean latency in ms of the reads sent) in each
    quarter of the window: a warm-up left inside it shows as a slower
    first quarter."""
    q = ctx.seconds / 4
    out = []
    for i in range(4):
        lo, hi = ctx.window_start + i * q, ctx.window_start + (i + 1) * q
        done = sum(1 for r in ctx.records if r.error is None and lo <= r.done < hi)
        lat = [(r.done - r.sent) * 1e3 for r in ctx.records if lo <= r.sent < hi]
        out.append((done, sum(lat) / len(lat) if lat else 0.0))
    return out


def check(cell: Cell, ctx: Ctx, device: str) -> Dict[str, dict]:
    """The sampled answers of each kind against its reference: the
    compared numbers, each with its limit (largest over the kinds)."""
    answered = [r for r in ctx.records if r.error is None]
    out: Dict[str, dict] = {}
    r = seeded(ctx.seed, "sample")
    for ki, kind in enumerate(ctx.kinds):
        mine = [x for x in answered if ctx.items[x.item].kind == ki]
        n = min(len(mine), int(kind["sample"]))
        pick = sorted(r.choice(len(mine), n, replace=False).tolist()) if n else []
        mod = cell.read_kind(kind["read"])
        got = mod.check(ctx.data, kind, [(ctx.items[mine[i].item].arg, mine[i].raw) for i in pick],
                        device)
        for name, value in got.items():
            limit = mod.LIMITS[name]
            old = out.get(name)
            if old is None or value > old["value"]:
                out[name] = {"value": value, "limit": limit}
    out["failed_reads"] = {"value": sum(1 for x in ctx.records if x.error is not None), "limit": 0}
    return out


def device_info(device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def power_limit() -> Optional[str]:
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.returncode == 0 and p.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, after_load=None) -> dict:
    """One run of the cell on `device`; returns the result object. The
    reference runs once the window has closed, the peak has been read
    and the program's state is freed. `after_load(ctx)` lets a test break
    the timed path under the harness."""
    import torch

    t_start = time.time() if t_start is None else t_start
    ctx = Ctx(cell, seed, seconds, trace)
    system = cell.system()
    data = system.generate(cell.config, seed, device, log)
    ctx.data = data
    prepare(cell, ctx, data)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.state = system.load(cell.config, data, device, log)
    if after_load is not None:
        after_load(ctx)
    clients = int(cell.traffic["clients"])
    t0 = time.perf_counter()
    warm_up(ctx, clients, int(cell.traffic["warmup_per_client"]))
    log(f"warm-up {time.perf_counter() - t0:.3f} s")
    metrics = cell.per_layer if trace else cell.end_to_end
    for m in metrics:
        start = getattr(cell.metric(m["name"]), "start", None)
        if start is not None:
            start(ctx)
    if trace:
        from portbench.devtrace import Trace

        with Trace(device) as tr:
            window(ctx, clients, t_start)
        ctx.devtrace = tr
    else:
        window(ctx, clients, t_start)
    log(f"window: {len(ctx.records)} reads sent, {ctx.answered_in_window()} answered in "
        f"{seconds} s; setup {ctx.setup_s:.3f} s")
    values = {}
    for m in metrics:
        v = cell.metric(m["name"]).read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = device_info(device, cell.chips)
    if trace:
        dev["busy_s"] = ctx.devtrace.busy_s()
        dev["window_s"] = ctx.devtrace.window_s
        if device == "cuda":
            dev["power_limit"] = power_limit()
    result = {"correct": False, "attempted": len(ctx.records),
              "failed": sum(1 for r in ctx.records if r.error is not None),
              "metrics": values, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": ctx.devtrace.top_ops(10),
                               "idle_gaps": ctx.devtrace.idle_gaps(10)}
        ctx.devtrace = None
    # free the program's state before the reference runs
    ctx.state.close()
    ctx.state = None
    ctx.store.clear()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check(cell, ctx, device)
    log(f"check {time.perf_counter() - t0:.3f} s")
    result["correct"] = bool(ctx.records) and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(workload: str, seed: int, seconds: float, trace: bool, root: str,
         t_start: float) -> int:
    try:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            spec = json.load(f)
        cell = Cell(spec, workload, root)
    except (OSError, KeyError, ValueError) as e:
        log(f"no such cell: {e}")
        return 1
    # every build and kernel cache of the program inside the checkout, at
    # fixed paths: the port's kernels build under dgraph_tpu_torch/_build
    cache = os.path.join(root, ".portbench_cache")
    os.environ["DGRAPH_TPU_NATIVE_CACHE"] = os.path.join(cache, "native")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"the cell needs {cell.chips} CUDA device(s); this machine has {n}")
        return 2
    try:
        result = run(cell, seed, seconds, trace, "cuda", t_start)
    except Exception:  # noqa: BLE001 - a run that breaks prints no result
        traceback.print_exc()
        return 1
    bad = isolation.loaded_forbidden()
    if bad:
        log(f"JAX was loaded in this process: {bad}")
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
