"""CLI: the `dgraph` binary equivalent (ref dgraph/dgraph/cmd).

Subcommands mirror the reference's cobra tree (root.go:80):
  alpha    — serve the HTTP API (ref cmd/alpha)
  bulk     — offline bulk load RDF into a data dir (ref cmd/bulk)
  live     — transactional load into a running data dir (ref cmd/live)
  export   — dump RDF/JSON + schema (ref worker/export.go)
  backup / restore — manifest-chain backups, local or --addr online
             against a live cluster (ref worker/backup*.go,
             worker/online_restore.go)
  cdc      — manage/tail the CDC stream of a running alpha
             (ref worker/cdc.go)
  acl      — user/group/rule administration (ref cmd/acl)
  increment — smoke-test counter (ref cmd/increment)
  debug    — p-dir inspector (ref cmd/debug)
  mcp      — MCP server on stdio (ref cmd/mcp)
  cert     — TLS CA/node/client certs (ref cmd/cert)
  conv     — geo/JSON -> RDF conversion (ref cmd/conv)
  migrate  — relational CSV -> RDF + schema (ref cmd/migrate)
  debuginfo — support bundle (ref cmd/debuginfo)
  top      — top query shapes by latency share (/debug/digests)
  debug-bundle — one-command flight-recorder tarball (metrics,
             digests, history, health, traces, lock graph, config)
  upgrade  — on-disk layout migrations (ref upgrade/)
  version

Usage: python -m dgraph_tpu_torch <subcommand> [...]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _server(args):
    from dgraph_tpu_torch.api.server import Server
    from dgraph_tpu_torch.x.flags import STORAGE_DEFAULTS, SuperFlag

    key = None
    if getattr(args, "encryption_key_file", None):
        from dgraph_tpu_torch.enc.enc import read_key_file

        key = read_key_file(args.encryption_key_file)
    sf = SuperFlag(getattr(args, "storage", "") or "", STORAGE_DEFAULTS)
    if key is None and sf.get_string("encryption-key-file"):
        from dgraph_tpu_torch.enc.enc import read_key_file

        key = read_key_file(sf.get_string("encryption-key-file"))
    backend = sf.get_string("backend", "mem")
    if backend != "mem":
        from dgraph_tpu_torch.x import config

        config.set_env("STORAGE", backend)
    return Server(device=args.device, data_dir=args.p, encryption_key=key)


def cmd_alpha(args):
    from dgraph_tpu_torch.api.http_server import HTTPServer

    if getattr(args, "cluster", ""):
        from dgraph_tpu_torch.worker.facade import ClusterFacade
        from dgraph_tpu_torch.worker.groups import DistributedCluster
        from dgraph_tpu_torch.x.flags import SuperFlag

        cf = SuperFlag(
            args.cluster,
            "groups=2; replicas=3; learners=0; replicated-zero=false",
        )
        cluster = DistributedCluster(
            device=args.device,
            n_groups=cf.get_int("groups", 2),
            replicas=cf.get_int("replicas", 3),
            data_dir=args.p,
            learners_per_group=cf.get_int("learners", 0),
            replicated_zero=cf.get_bool("replicated-zero"),
        )
        engine = ClusterFacade(cluster)
    else:
        engine = _server(args)
    if args.schema:
        with open(args.schema) as f:
            engine.alter(f.read())
    if args.acl_secret_file:
        with open(args.acl_secret_file, "rb") as f:
            engine.enable_acl(secret=f.read().strip())
    if args.audit_dir:
        engine.enable_audit(args.audit_dir)
    from dgraph_tpu_torch.x import config as _config

    cdc_sink = args.cdc_file or _config.get("CDC_SINK")
    if cdc_sink:
        from dgraph_tpu_torch.admin.cdc import cdc_for_uri

        cdc_for_uri(engine, cdc_sink)
    if args.rollup_interval > 0:
        from dgraph_tpu_torch.posting.rollup import RollupDaemon

        RollupDaemon(engine, interval_s=args.rollup_interval).start()
    from dgraph_tpu_torch.x.flags import TRACE_DEFAULTS, SuperFlag

    tf = SuperFlag(getattr(args, "trace", "") or "", TRACE_DEFAULTS)
    if tf.get_string("sink-file"):
        from dgraph_tpu_torch.utils import observe

        # point the GLOBAL tracer at the sink (replacing the instance
        # would orphan every module that imported TRACER by value)
        observe.TRACER.set_sink(tf.get_string("sink-file"))
    srv = HTTPServer(engine, host=args.bind, port=args.port).start()
    print(f"alpha listening on http://{args.bind}:{srv.port}")
    if args.grpc_port >= 0:
        from dgraph_tpu_torch.api.grpc_server import serve as grpc_serve

        _, gport = grpc_serve(engine, host=args.bind, port=args.grpc_port)
        print(f"alpha gRPC (api.Dgraph) on {args.bind}:{gport}")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def cmd_bulk(args):
    import time

    from dgraph_tpu_torch.loaders.bulk2 import ParallelBulkLoader

    engine = _server(args)
    if args.schema:
        with open(args.schema) as f:
            engine.alter(f.read())
    t0 = time.time()
    loader = ParallelBulkLoader(engine)
    loader.load_files(list(args.files))
    n = loader.nquads
    engine.kv.sync() if hasattr(engine.kv, "sync") else None
    print(f"bulk loaded {n} nquads in {time.time()-t0:.1f}s")


def cmd_live(args):
    from dgraph_tpu_torch.loaders.live import LiveLoader

    engine = _server(args)
    if args.schema:
        with open(args.schema) as f:
            engine.alter(f.read())
    ll = LiveLoader(engine, batch_size=args.batch)
    for path in args.files:
        ll.load_rdf_file(path)
    print(
        f"live loaded {ll.nquads_loaded} nquads in {ll.txns_committed} txns "
        f"({ll.aborts} aborts)"
    )


def cmd_import(args):
    """dgraphimport equivalent (ref dgraphimport/, the snapshot-stream
    import tool): bulk-load an exported dataset (schema + rdf[.gz]) into
    a fresh or running data dir, picking bulk (offline, rollup writes)
    or live (transactional) mode."""
    import glob as _glob

    files = []
    schema = args.schema
    for pat in args.files:
        for path in sorted(_glob.glob(pat)):
            if path.endswith((".schema", ".schema.gz")):
                schema = schema or path
            else:
                files.append(path)
    args.files = files
    args.schema = schema
    if args.mode == "live":
        return cmd_live(args)
    return cmd_bulk(args)


def cmd_export(args):
    from dgraph_tpu_torch.admin.export import export

    out = export(_server(args), args.out, fmt=args.format)
    print(json.dumps(out))


def _admin_call(addr: str, path: str, timeout: float = 300.0):
    """POST an /admin op against a running alpha; returns the JSON body
    or exits nonzero with the error on stderr."""
    import urllib.error
    import urllib.request

    url = addr.rstrip("/") + path
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except Exception:
            body = {"errors": [{"message": str(e)}]}
        print(json.dumps(body), file=sys.stderr)
        return None
    except Exception as e:
        print(f"{url}: {e}", file=sys.stderr)
        return None


def cmd_backup(args):
    """Backup a local data dir — or, with --addr, a LIVE cluster: the
    running alpha coordinates a journaled online backup (distributed
    driver when it serves a cluster) while writes keep flowing."""
    from urllib.parse import quote

    if args.addr:
        out = _admin_call(
            args.addr,
            f"/admin/backup?destination={quote(args.dest)}"
            + ("&full=true" if args.full else ""),
        )
        if out is None:
            return 1
        print(json.dumps(out.get("data", out)))
        return 0
    from dgraph_tpu_torch.admin.backup import backup

    entry = backup(_server(args), args.dest, incremental=not args.full)
    print(json.dumps(entry))


def cmd_restore(args):
    """Restore a manifest chain into a local data dir — or, with
    --addr, ONLINE into a live cluster (verified records proposed
    through each group's raft log; leases + snapshot watermark advance
    so the data is immediately visible)."""
    from urllib.parse import quote

    if args.addr:
        out = _admin_call(
            args.addr, f"/admin/restore?source={quote(args.src)}"
        )
        if out is None:
            return 1
        print(json.dumps(out.get("data", out)))
        return 0
    from dgraph_tpu_torch.admin.backup import restore

    n = restore(_server(args), args.src)
    print(f"restored {n} records")


def cmd_cdc(args):
    """Manage the CDC stream of a running alpha: point it at a sink
    (--sink), turn it off (--disable), probe its status (default), or
    tail an ndjson sink file (--follow)."""
    from urllib.parse import quote

    if args.follow:
        import time as _t

        with open(args.follow) as f:
            while True:
                line = f.readline()
                if line:
                    sys.stdout.write(line)
                    sys.stdout.flush()
                elif args.once:
                    return 0
                else:
                    _t.sleep(0.2)
    if args.disable:
        out = _admin_call(args.addr, "/admin/cdc?disable=true")
    elif args.sink:
        out = _admin_call(args.addr, f"/admin/cdc?sink={quote(args.sink)}")
    else:
        out = _admin_call(args.addr, "/admin/cdc")
    if out is None:
        return 1
    print(json.dumps(out.get("data", out)))
    return 0


def cmd_acl(args):
    engine = _server(args)
    acl = engine.enable_acl()
    if args.acl_cmd == "add-user":
        acl.add_user(args.user, args.password)
        print(f"user {args.user} created")
    elif args.acl_cmd == "add-group":
        acl.add_group(args.group)
        print(f"group {args.group} created")
    elif args.acl_cmd == "add-to-group":
        acl.add_user_to_group(args.user, args.group)
        print("ok")
    elif args.acl_cmd == "set-rule":
        acl.set_rule(args.group, args.predicate, args.perm)
        print("ok")


def cmd_increment(args):
    """Smoke test: read-modify-write a counter N times
    (ref dgraph/cmd/increment)."""
    engine = _server(args)
    engine.alter("counter.val: int .")
    for _ in range(args.num):
        txn = engine.new_txn()
        res = txn.query("{ q(func: uid(0x1)) { counter.val } }")
        cur = res["data"]["q"][0]["counter.val"] if res["data"]["q"] else 0
        txn.mutate_rdf(
            set_rdf=f'<0x1> <counter.val> "{cur + 1}"^^<xs:int> .'
        )
        txn.commit()
    res = engine.query("{ q(func: uid(0x1)) { counter.val } }")
    print(f"counter: {res['data']['q'][0]['counter.val']}")


def cmd_debug(args):
    """Inspect a p-dir: key histogram per predicate (ref cmd/debug)."""
    from dgraph_tpu_torch.x import keys as xkeys

    engine = _server(args)
    hist = {}
    for key, _, _ in engine.kv.iterate(b"", 1 << 62):
        try:
            pk = xkeys.parse_key(key)
        except Exception:
            continue
        kind = (
            "schema" if pk.is_schema else
            "type" if pk.is_type else
            "data" if pk.is_data else
            "index" if pk.is_index else
            "reverse" if pk.is_reverse else
            "count"
        )
        hist.setdefault(pk.attr, {}).setdefault(kind, 0)
        hist[pk.attr][kind] += 1
    print(json.dumps(hist, indent=2, sort_keys=True))


def cmd_mcp(args):
    from dgraph_tpu_torch.api.mcp_server import McpServer

    McpServer(_server(args)).serve_stdio()




def cmd_cert(args):
    from dgraph_tpu_torch import tools

    if args.ls:
        for row in tools.cert_ls(args.dir):
            print(row["file"], "|", row["info"].replace("\n", " "))
        return
    made = tools.cert_create(
        args.dir,
        nodes=[n for n in args.nodes.split(",") if n],
        client=args.client or None,
    )
    for k, v in made.items():
        print(f"created {k}: {v}")


def cmd_conv(args):
    from dgraph_tpu_torch import tools

    rdf = []
    if args.geo:
        rdf += tools.conv_geojson(args.geo)
    if args.json_file:
        rdf += tools.conv_json(args.json_file)
    text = "\n".join(rdf) + "\n"
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)


def cmd_migrate(args):
    from dgraph_tpu_torch import tools

    tables = dict(kv.split("=", 1) for kv in args.tables.split(","))
    schema, rdf = tools.migrate_csv(tables)
    with open(args.out_schema, "w") as f:
        f.write(schema + "\n")
    with open(args.out_rdf, "w") as f:
        f.write("\n".join(rdf) + "\n")
    print(f"wrote {len(rdf)} nquads to {args.out_rdf}")


def cmd_debuginfo(args):
    from dgraph_tpu_torch import tools

    engine = _server(args)
    bundle = tools.debuginfo(engine, args.out)
    print(f"bundle: {bundle}")


def cmd_decrypt(args):
    """Decrypt an encrypted export/backup file offline (ref
    dgraph/cmd/decrypt/decrypt.go:47 — enc.GetReader + optional gzip,
    output re-gzipped)."""
    import gzip

    from dgraph_tpu_torch.enc import enc

    key = enc.read_key_file(args.encryption_key_file)
    with open(args.file, "rb") as f:
        data = f.read()
    plain = enc.decrypt_stream(data, key)
    if args.file.lower().endswith(".gz"):
        plain = gzip.decompress(plain)
    # the reference writes the output gzip-compressed
    with gzip.open(args.out, "wb") as out:
        out.write(plain)
    print(f"decrypted {args.file} -> {args.out}")


def cmd_upgrade(args):
    from dgraph_tpu_torch import tools

    applied = tools.upgrade(args.p)
    print(
        f"layout now v{tools.layout_version(args.p)}; applied: {applied or 'none'}"
    )

def cmd_lint(args):
    """Run the project-invariant analyzer suite (dgraph_tpu_torch/analysis).

    Exit-code contract (stable, for external CI):
      0 — clean: no unallowlisted violations, no stale allowlist entries
      1 — violations (or stale allowlist entries) found
      2 — internal analyzer error
    """
    import json as _json
    import traceback

    from dgraph_tpu_torch import analysis

    try:
        checkers = None
        if getattr(args, "checker", None):
            unknown = set(args.checker) - set(analysis.CHECKERS)
            if unknown:
                print(
                    f"unknown checker(s) {sorted(unknown)}; available: "
                    f"{sorted(analysis.CHECKERS)}"
                )
                return 2
            checkers = args.checker
        rep = analysis.run(checkers=checkers)
    except Exception:
        traceback.print_exc()
        return 2
    if args.json:
        print(_json.dumps(rep.to_dict(), indent=2))
    else:
        for v in rep.violations:
            print(v.render())
        for a in rep.unused_allows:
            print(
                f"allowlist.py: stale entry ({a.checker}, {a.path}, "
                f"{a.match!r}) matches nothing — remove it"
            )
        print(
            f"lint: {len(rep.violations)} violation(s), "
            f"{len(rep.suppressed)} allowlisted, "
            f"{len(rep.unused_allows)} stale allowlist entr(y/ies)"
        )
    return 0 if rep.ok else 1


def cmd_metrics(args):
    """Scrape the cluster-merged metrics endpoint of a running alpha
    (`/debug/prometheus_metrics`: counters summed across every alpha/
    zero process, histograms bucket-merged, per-instance labels kept)
    and print the exposition text — or, with --json, a parsed
    {counters, gauges, histograms} object."""
    import urllib.request

    from dgraph_tpu_torch.utils import observe

    url = args.addr.rstrip("/") + "/debug/prometheus_metrics"
    try:
        text = urllib.request.urlopen(
            url, timeout=args.timeout
        ).read().decode("utf-8")
    except Exception as e:
        print(f"scrape of {url} failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        parsed = observe.parse_exposition(text)
        print(
            json.dumps(
                {
                    "counters": parsed["counter"],
                    "gauges": parsed["gauge"],
                    "histograms": parsed["histogram"],
                },
                indent=2,
                sort_keys=True,
            )
        )
    else:
        print(text, end="")
    return 0


def render_plan(plan: dict) -> str:
    """Human-readable EXPLAIN rendering of an extensions.plan tree:
    one indented line per (predicate, level) node with uids in/out,
    read strategy, wall time, and kernel counts, preceded by the
    query-level decisions (plan cache, admission, cache tiers,
    micro-batching, set-op routing). Pure — unit-tested against a
    captured plan (tests/test_explain.py)."""
    lines = []
    wall = plan.get("wall_ns")
    head = "Query plan"
    if wall is not None:
        head += f" (wall {wall / 1e6:.2f}ms"
        if "read_ts" in plan:
            head += f", read_ts {plan['read_ts']}"
        if "snapshot_watermark" in plan:
            head += f", watermark {plan['snapshot_watermark']}"
        head += ")"
    lines.append(head)
    pc = plan.get("plan_cache") or {}
    if pc:
        if not pc.get("enabled", True):
            lines.append("  plan cache: disabled")
        else:
            shape = pc.get("shape")
            lines.append(
                "  plan cache: %s%s"
                % (
                    "HIT" if pc.get("hit") else "MISS",
                    f'  shape="{shape}"' if shape else "",
                )
            )
    adm = plan.get("admission") or {}
    if adm:
        lines.append(
            "  admission: cost %s (%s%s)"
            % (
                adm.get("cost"),
                "gate on" if adm.get("enabled") else "gate off",
                ", degraded" if adm.get("degrade") else "",
            )
        )
    cache = plan.get("cache") or {}
    if cache:
        lines.append(
            "  cache: %d memlayer hits / %d misses, "
            "%d batch reads (%d keys), %d point reads"
            % (
                cache.get("memlayer_hits", 0),
                cache.get("memlayer_misses", 0),
                cache.get("batch_reads", 0),
                cache.get("batch_read_keys", 0),
                cache.get("point_reads", 0),
            )
        )
    mb = plan.get("microbatch") or {}
    if mb.get("coalesced") or mb.get("solo"):
        lines.append(
            "  microbatch: %d coalesced (max width %d) / %d solo"
            % (
                mb.get("coalesced", 0),
                mb.get("members_max", 0),
                mb.get("solo", 0),
            )
        )
    setops = plan.get("setops") or []
    if setops:
        packed = sum(1 for s in setops if s.get("verdict") == "packed")
        pushed = sum(1 for s in setops if s.get("verdict") == "pushdown")
        lines.append(
            "  setops: %d decisions, %d packed / %d decoded%s%s"
            % (
                len(setops),
                packed,
                len(setops) - packed - pushed,
                f", {pushed} pushdown" if pushed else "",
                (
                    f" ({plan['setops_dropped']} dropped)"
                    if plan.get("setops_dropped")
                    else ""
                ),
            )
        )
    pl = plan.get("planner") or {}
    if pl:
        if not pl.get("enabled", False):
            lines.append("  planner: off")
        else:
            lines.append(
                "  planner: on, %d reorders, %d pushdowns"
                % (pl.get("reorders", 0), pl.get("pushdowns", 0))
            )
            for so in pl.get("sibling_orders", ()):
                lines.append(
                    "    sibling order: %s" % " -> ".join(so.get("order", ()))
                )
            for ao in pl.get("and_orders", ()):
                lines.append(
                    "    filter AND order: %s"
                    % " -> ".join(str(i) for i in ao.get("order", ()))
                )
    rc = plan.get("result_cache") or {}
    if rc:
        if not rc.get("enabled", False):
            lines.append("  result cache: disabled")
        else:
            lines.append(
                "  result cache: %s (watermark %s)"
                % (
                    "WOULD-HIT (EXPLAIN always executes)"
                    if rc.get("would_hit")
                    else ("eligible, cold" if rc.get("eligible") else "ineligible"),
                    rc.get("watermark"),
                )
            )

    def walk(node, depth):
        kern = node.get("kernels") or {}
        kern_s = ""
        if kern:
            kern_s = " kernels{%s}" % ", ".join(
                f"{k}={int(v)}" for k, v in sorted(kern.items())
            )
        if node.get("read") == "root":
            lines.append(
                "  %s%s (root%s) -> %d uids"
                % (
                    "  " * depth,
                    node.get("attr"),
                    f" func={node['func']}" if node.get("func") else "",
                    node.get("uids_out", 0),
                )
            )
        else:
            est = node.get("est_out")
            lines.append(
                "  %s%s level=%d [%s] %d -> %d uids%s, %.2fms%s"
                % (
                    "  " * depth,
                    node.get("attr"),
                    node.get("level", 0),
                    node.get("read", "?"),
                    node.get("uids_in", 0),
                    node.get("uids_out", 0),
                    f" (est {est})" if est is not None else "",
                    node.get("wall_ns", 0) / 1e6,
                    kern_s,
                )
            )
        for c in node.get("children", ()):
            walk(c, depth + 1)

    for root in plan.get("nodes", ()):
        walk(root, 0)
    return "\n".join(lines)


def cmd_explain(args):
    """EXPLAIN/ANALYZE a query: run it with debug=true against a
    running alpha (--addr) or a local data dir (-p) and render the
    extensions.plan tree as an indented plan."""
    query = args.query
    if query == "-":
        query = sys.stdin.read()
    if args.addr:
        import urllib.request

        req = urllib.request.Request(
            args.addr.rstrip("/") + "/query?debug=true",
            data=query.encode("utf-8"),
            method="POST",
            headers={"Content-Type": "application/dql"},
        )
        try:
            res = json.loads(
                urllib.request.urlopen(req, timeout=args.timeout).read()
            )
        except Exception as e:
            print(f"query against {args.addr} failed: {e}", file=sys.stderr)
            return 1
        if res.get("errors"):
            print(json.dumps(res["errors"], indent=2), file=sys.stderr)
            return 1
    else:
        from dgraph_tpu_torch.api.server import Server

        server = Server(device=args.device, data_dir=args.p)
        res = server.query(query, debug=True)
    plan = (res.get("extensions") or {}).get("plan")
    if plan is None:
        print("no extensions.plan in the response", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(plan, indent=2, sort_keys=True))
    else:
        print(render_plan(plan))
    return 0


def _render_health(h: dict) -> str:
    lines = [
        "status: %s  (instance %s, pid %s, up %.0fs)"
        % (
            h.get("status", "?"), h.get("instance", "?"),
            h.get("pid", "?"), h.get("uptime_s", 0),
        )
    ]
    if "snapshot_watermark" in h:
        lag = h.get("watermark_lag")
        lines.append(
            "watermark: %s%s"
            % (
                h["snapshot_watermark"],
                f" (lag {lag})" if lag is not None else "",
            )
        )
    adm = h.get("admission") or {}
    lines.append(
        "admission: %d in flight, %d shed, %d degraded"
        % (
            adm.get("inflight", 0), adm.get("shed_total", 0),
            adm.get("degraded_queries_total", 0),
        )
    )
    lines.append(
        "commit pipeline depth: %d" % h.get("commit_pipeline_depth", 0)
    )
    for gid, g in sorted((h.get("groups") or {}).items()):
        reps = []
        for nid, r in sorted(g.get("replicas", {}).items()):
            if not r.get("ok"):
                reps.append(f"{nid}:DOWN")
            else:
                tag = "*" if r.get("is_leader") else ""
                lag = r.get("applied_lag", 0)
                reps.append(
                    f"{nid}{tag}@{r.get('applied', 0)}"
                    + (f"(-{lag})" if lag else "")
                )
        lines.append(
            "group %s: %s  [%s]"
            % (
                gid,
                "leader=%s" % g.get("leader")
                if g.get("healthy")
                else "NO LEADER",
                " ".join(reps),
            )
        )
    for name, rep in sorted((h.get("slo") or {}).items()):
        wins = rep.get("windows", {})
        burn = ", ".join(
            f"{w}={v.get('burn_rate')}" for w, v in sorted(wins.items())
        )
        lines.append(
            "slo %s (<=%sms @ %s): burn %s"
            % (name, rep.get("threshold_ms"), rep.get("target"), burn)
        )
    unreachable = h.get("unreachable_instances")
    if unreachable:
        lines.append("unreachable: " + ", ".join(unreachable))
    return "\n".join(lines)


def cmd_health(args):
    """Scrape + print the cluster health/SLO rollup of a running alpha
    (/debug/healthz: per-group raft leadership and applied-index lag,
    snapshot-watermark lag, commit pipeline depth, admission shed and
    degraded rates, multi-window SLO burn rates)."""
    import urllib.request

    url = args.addr.rstrip("/") + "/debug/healthz"
    try:
        h = json.loads(
            urllib.request.urlopen(url, timeout=args.timeout).read()
        )
    except Exception as e:
        print(f"scrape of {url} failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(h, indent=2, sort_keys=True))
    else:
        print(_render_health(h))
    return 0


def _render_top(rows, n: int) -> str:
    """Top-N digest rows by latency share — one line per (ns, shape)."""
    total_lat = sum(r.get("lat_sum", 0.0) for r in rows) or 1.0
    lines = [
        "%8s %6s %7s %7s %9s %6s %6s %4s  %s"
        % (
            "CALLS", "ERR", "LAT%", "MEAN_MS", "ROWS", "PHIT%",
            "RHIT%", "NS", "SHAPE",
        )
    ]
    for r in rows[:n]:
        calls = r.get("calls", 0) or 0
        lat = r.get("lat_sum", 0.0)
        shape = r.get("shape", "")
        if len(shape) > 88:
            shape = shape[:85] + "..."
        lines.append(
            "%8d %6d %6.1f%% %7.2f %9d %5.0f%% %5.0f%% %4s  %s"
            % (
                calls,
                r.get("errors", 0),
                100.0 * lat / total_lat,
                (lat / calls * 1e3) if calls else 0.0,
                r.get("rows", 0),
                100.0 * r.get("plan_hits", 0) / calls if calls else 0.0,
                100.0 * r.get("result_hits", 0) / calls if calls else 0.0,
                r.get("ns", "?"),
                shape,
            )
        )
    return "\n".join(lines)


def cmd_top(args):
    """pg_stat_statements for the cluster: scrape /debug/digests of a
    running alpha (cluster-merged per-(namespace, shape) aggregates)
    and render the top-N query shapes by latency share. `--watch`
    refreshes in place every --interval seconds."""
    import urllib.request

    url = args.addr.rstrip("/") + "/debug/digests"

    def fetch():
        body = json.loads(
            urllib.request.urlopen(url, timeout=args.timeout).read()
        )
        return body

    try:
        while True:
            try:
                body = fetch()
            except Exception as e:
                print(f"scrape of {url} failed: {e}", file=sys.stderr)
                return 1
            rows = body.get("digests", [])
            if args.json:
                print(json.dumps(body, indent=2, sort_keys=True))
            else:
                if args.watch:
                    sys.stdout.write("\x1b[2J\x1b[H")
                unreachable = body.get("unreachable_instances") or []
                if unreachable:
                    print(
                        "WARNING: partial merge, unreachable: "
                        + ", ".join(unreachable)
                    )
                print(_render_top(rows, args.n))
            if not args.watch:
                return 0
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def cmd_debug_bundle(args):
    """One-command flight-recorder capture: fetch merged metrics,
    digests, a history window, health, traces, tablets, the slow-query
    log, and the resolved config from a running alpha, compute the
    static lock graph locally, and pack everything into one tarball. A
    dead alpha (or any failing endpoint) yields a PARTIAL bundle with
    the failure recorded in MANIFEST.json — never an empty exit."""
    import io
    import tarfile
    import urllib.parse
    import urllib.request

    base = args.addr.rstrip("/")
    window = float(args.window)
    endpoints = {
        "metrics.prom": "/debug/prometheus_metrics",
        "digests.json": "/debug/digests",
        "history.json": (
            "/debug/history?" + urllib.parse.urlencode({"window": window})
        ),
        "health.json": "/debug/healthz",
        "traces.json": "/debug/traces",
        "tablets.json": "/debug/tablets",
        "slowlog.jsonl": "/debug/slowlog",
        "config.json": "/debug/config",
    }
    files: dict = {}
    manifest: dict = {
        "generated": time.time(),
        "addr": base,
        "window_s": window,
        "files": {},
        "unreachable_instances": [],
    }
    unreachable = set()
    for name, path in endpoints.items():
        url = base + path
        try:
            data = urllib.request.urlopen(
                url, timeout=args.timeout
            ).read()
            files[name] = data
            manifest["files"][name] = {"ok": True, "bytes": len(data)}
            if name.endswith(".json"):
                try:
                    body = json.loads(data)
                    unreachable.update(
                        body.get("unreachable_instances") or []
                    )
                except ValueError:
                    pass
        except Exception as e:
            manifest["files"][name] = {"ok": False, "error": str(e)}
            print(f"  {name}: FAILED ({e})", file=sys.stderr)
    # the static lock graph (PR 19's analyzer) and resolved config are
    # computed locally — they describe the code/process, not the
    # cluster, so a dead alpha cannot take them down
    try:
        from dgraph_tpu_torch.analysis import load_sources, package_root
        from dgraph_tpu_torch.analysis.check_lockorder import lock_graph

        edges = [
            {
                "outer": outer,
                "inner": inner,
                "path": path,
                "line": line,
                "kind": kind,
            }
            for (outer, inner), (path, line, kind) in sorted(
                lock_graph(load_sources(package_root())).items()
            )
        ]
        files["lockgraph.json"] = json.dumps(
            {"edges": edges}, indent=2
        ).encode()
        manifest["files"]["lockgraph.json"] = {"ok": True}
    except Exception as e:
        manifest["files"]["lockgraph.json"] = {
            "ok": False, "error": str(e),
        }
    if "config.json" not in files:
        from dgraph_tpu_torch.x import config as _cfg

        files["config.json"] = json.dumps(
            _cfg.resolved(), indent=2, default=str
        ).encode()
        manifest["files"]["config.json"] = {"ok": True, "local": True}
    manifest["unreachable_instances"] = sorted(unreachable)
    out_path = args.out or time.strftime("debug-bundle-%Y%m%d-%H%M%S.tar.gz")
    files["MANIFEST.json"] = json.dumps(
        manifest, indent=2, sort_keys=True
    ).encode()
    with tarfile.open(out_path, "w:gz") as tar:
        for name in sorted(files):
            data = files[name]
            info = tarfile.TarInfo(name=f"debug-bundle/{name}")
            info.size = len(data)
            info.mtime = int(manifest["generated"])
            tar.addfile(info, io.BytesIO(data))
    ok = sum(1 for f in manifest["files"].values() if f.get("ok"))
    total = len(manifest["files"])
    partial = "" if ok == total else f" (PARTIAL: {ok}/{total} sections)"
    print(f"wrote {out_path}{partial}")
    if manifest["unreachable_instances"]:
        print(
            "unreachable instances: "
            + ", ".join(manifest["unreachable_instances"])
        )
    return 0


def cmd_metrics_ref(args):
    """Regenerate (or print) the METRICS.md metric-name reference."""
    from dgraph_tpu_torch.utils import observe

    text = observe.metrics_reference()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    return 0


def cmd_config_ref(args):
    """Regenerate (or print) the CONFIG.md env-var reference."""
    from dgraph_tpu_torch.x import config

    text = config.reference_table()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dgraph-tpu")
    ap.add_argument("--version", action="version", version="dgraph-tpu 0.1.0")
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="the torch device every engine serves on (cuda raises "
        "without a card)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_p(p):
        p.add_argument("-p", default=None, help="data directory (default: in-memory)")

    p = sub.add_parser("alpha", help="serve the HTTP API")
    p.add_argument(
        "--storage",
        default="",
        help='superflag: "backend=mem|lsm; encryption-key-file=...; memtable-mb=8"',
    )
    p.add_argument(
        "--cluster",
        default="",
        help='serve a sharded cluster: "groups=2; replicas=3; '
        'learners=0; replicated-zero=true"',
    )
    p.add_argument(
        "--trace",
        default="",
        help='superflag: "sink-file=...; ratio=0.01"',
    )
    p.add_argument(
        "--encryption_key_file",
        default=None,
        help="AES key file enabling at-rest value encryption",
    )
    p.add_argument(
        "--grpc_port",
        type=int,
        default=9080,
        help="api.Dgraph gRPC port (-1 disables; 0 = OS-assigned)",
    )
    add_p(p)
    p.add_argument("--bind", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--schema", default=None)
    p.add_argument("--acl-secret-file", default=None)
    p.add_argument("--audit-dir", default=None)
    p.add_argument("--cdc-file", default=None)
    p.add_argument("--rollup-interval", type=float, default=30.0)
    p.set_defaults(fn=cmd_alpha)

    p = sub.add_parser("bulk", help="offline bulk load")
    add_p(p)
    p.add_argument("--schema", default=None)
    p.add_argument(
        "--storage",
        default="",
        help='superflag: "backend=mem|lsm; encryption-key-file=..."',
    )
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_bulk)

    p = sub.add_parser(
        "import", help="import an exported dataset (dgraphimport equivalent)"
    )
    p.add_argument("files", nargs="+", help="rdf/schema files or globs")
    p.add_argument("-p", default=None)
    p.add_argument("--schema", default=None)
    p.add_argument("--mode", choices=("bulk", "live"), default="bulk")
    p.add_argument("--batch", type=int, default=1000)
    p.set_defaults(fn=cmd_import)

    p = sub.add_parser("live", help="transactional load")
    add_p(p)
    p.add_argument("--schema", default=None)
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("export")
    add_p(p)
    p.add_argument("--out", required=True)
    p.add_argument("--format", choices=["rdf", "json"], default="rdf")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser(
        "backup",
        help="manifest-chain backup of a data dir, or (--addr) a "
        "journaled online backup coordinated by a running alpha",
    )
    add_p(p)
    p.add_argument("--dest", required=True)
    p.add_argument("--full", action="store_true")
    p.add_argument(
        "--addr", default="",
        help="base URL of a running alpha (online backup of the live "
        "cluster it serves)",
    )
    p.set_defaults(fn=cmd_backup)

    p = sub.add_parser(
        "restore",
        help="restore a manifest chain into a data dir, or (--addr) "
        "online into a live cluster",
    )
    add_p(p)
    p.add_argument("--src", required=True)
    p.add_argument(
        "--addr", default="",
        help="base URL of a running alpha (online restore)",
    )
    p.set_defaults(fn=cmd_restore)

    p = sub.add_parser(
        "cdc",
        help="manage/tail the CDC stream of a running alpha "
        "(--sink enables, --disable stops, default probes status, "
        "--follow tails an ndjson sink file)",
    )
    p.add_argument(
        "--addr", default="http://127.0.0.1:8080",
        help="base URL of the alpha HTTP endpoint",
    )
    p.add_argument("--sink", default="", help="ndjson sink path to enable")
    p.add_argument("--disable", action="store_true")
    p.add_argument(
        "--follow", default="",
        help="tail this ndjson sink file instead of calling the alpha",
    )
    p.add_argument(
        "--once", action="store_true",
        help="with --follow: dump current contents and exit",
    )
    p.set_defaults(fn=cmd_cdc)

    p = sub.add_parser("acl")
    add_p(p)
    asub = p.add_subparsers(dest="acl_cmd", required=True)
    a = asub.add_parser("add-user")
    a.add_argument("--user", required=True)
    a.add_argument("--password", required=True)
    a = asub.add_parser("add-group")
    a.add_argument("--group", required=True)
    a = asub.add_parser("add-to-group")
    a.add_argument("--user", required=True)
    a.add_argument("--group", required=True)
    a = asub.add_parser("set-rule")
    a.add_argument("--group", required=True)
    a.add_argument("--predicate", required=True)
    a.add_argument("--perm", type=int, required=True)
    p.set_defaults(fn=cmd_acl)

    p = sub.add_parser("increment", help="counter smoke test")
    add_p(p)
    p.add_argument("--num", type=int, default=1)
    p.set_defaults(fn=cmd_increment)

    p = sub.add_parser("debug", help="inspect a data dir")
    add_p(p)
    p.set_defaults(fn=cmd_debug)

    p = sub.add_parser("cert", help="create/list TLS certificates")
    p.add_argument("--dir", default="tls")
    p.add_argument("--nodes", default="", help="comma-separated node CNs")
    p.add_argument("--client", default="")
    p.add_argument("--ls", action="store_true")
    p.set_defaults(fn=cmd_cert)

    p = sub.add_parser("conv", help="convert geojson/json to RDF")
    p.add_argument("--geo", default="")
    p.add_argument("--json", dest="json_file", default="")
    p.add_argument("--out", default="-")
    p.set_defaults(fn=cmd_conv)

    p = sub.add_parser("migrate", help="relational CSV dump -> RDF")
    p.add_argument("--tables", required=True,
                   help="name=path[,name=path...] CSV tables")
    p.add_argument("--out-rdf", default="migrated.rdf")
    p.add_argument("--out-schema", default="migrated.schema")
    p.set_defaults(fn=cmd_migrate)

    p = sub.add_parser("debuginfo", help="collect a support bundle")
    p.add_argument("-p", default=None)
    p.add_argument("--out", default=".")
    p.set_defaults(fn=cmd_debuginfo)

    p = sub.add_parser("upgrade", help="apply on-disk layout migrations")
    p.add_argument("-p", required=True)
    p.set_defaults(fn=cmd_upgrade)

    p = sub.add_parser(
        "decrypt", help="decrypt an encrypted export/backup file"
    )
    p.add_argument("-f", "--file", required=True)
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--encryption-key-file", required=True)
    p.set_defaults(fn=cmd_decrypt)

    p = sub.add_parser("mcp", help="MCP server on stdio")
    add_p(p)
    p.set_defaults(fn=cmd_mcp)

    p = sub.add_parser(
        "lint",
        help="run the project-invariant static-analysis suite "
        "(exit 0 clean / 1 violations / 2 internal error)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable report on stdout",
    )
    p.add_argument(
        "--checker", action="append", default=None,
        help="run only this checker (repeatable); default: all",
    )
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser(
        "metrics",
        help="scrape + print the cluster-merged Prometheus metrics of "
        "a running alpha",
    )
    p.add_argument(
        "--addr", default="http://127.0.0.1:8080",
        help="base URL of the alpha HTTP endpoint",
    )
    p.add_argument(
        "--json", action="store_true",
        help="parsed {counters,gauges,histograms} JSON instead of text",
    )
    p.add_argument("--timeout", type=float, default=5.0)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "explain",
        help="EXPLAIN/ANALYZE a query: run with debug=true and render "
        "the plan tree",
    )
    p.add_argument("query", help="DQL query text ('-' reads stdin)")
    p.add_argument(
        "--addr", default="",
        help="base URL of a running alpha (default: run locally "
        "against -p / in-memory)",
    )
    add_p(p)
    p.add_argument(
        "--json", action="store_true",
        help="raw extensions.plan JSON instead of the rendered tree",
    )
    p.add_argument("--timeout", type=float, default=15.0)
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser(
        "health",
        help="scrape + print the cluster health/SLO rollup "
        "(/debug/healthz) of a running alpha",
    )
    p.add_argument(
        "--addr", default="http://127.0.0.1:8080",
        help="base URL of the alpha HTTP endpoint",
    )
    p.add_argument(
        "--json", action="store_true",
        help="raw healthz JSON instead of the rendered summary",
    )
    p.add_argument("--timeout", type=float, default=5.0)
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser(
        "top",
        help="top query shapes by latency share (cluster-merged "
        "/debug/digests — pg_stat_statements for DQL)",
    )
    p.add_argument(
        "--addr", default="http://localhost:8080",
        help="base URL of a running alpha",
    )
    p.add_argument(
        "-n", type=int, default=20, help="rows to show (default 20)"
    )
    p.add_argument(
        "--watch", action="store_true",
        help="refresh in place until interrupted",
    )
    p.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh interval with --watch (seconds)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="raw digest JSON instead of the rendered table",
    )
    p.add_argument("--timeout", type=float, default=5.0)
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser(
        "debug-bundle",
        help="capture metrics, digests, history, health, traces, "
        "slow-query log, lock graph, and resolved config into one "
        "tarball (partial bundle when instances are down)",
    )
    p.add_argument(
        "--addr", default="http://localhost:8080",
        help="base URL of a running alpha",
    )
    p.add_argument(
        "-o", "--out", default=None,
        help="output tarball path (default debug-bundle-<ts>.tar.gz)",
    )
    p.add_argument(
        "--window", type=float, default=600.0,
        help="history window to capture (seconds, default 600)",
    )
    p.add_argument("--timeout", type=float, default=10.0)
    p.set_defaults(fn=cmd_debug_bundle)

    p = sub.add_parser(
        "metrics-ref",
        help="print (or write) the generated metric-name reference "
        "(METRICS.md)",
    )
    p.add_argument("-o", "--out", default=None, help="write to this path")
    p.set_defaults(fn=cmd_metrics_ref)

    p = sub.add_parser(
        "config-ref",
        help="print (or write) the generated DGRAPH_TPU_* env reference",
    )
    p.add_argument("-o", "--out", default=None, help="write to this path")
    p.set_defaults(fn=cmd_config_ref)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
