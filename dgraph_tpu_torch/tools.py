"""Operator tools: cert / conv / migrate / debuginfo / upgrade.

Mirrors the reference's remaining dgraph subcommands
(dgraph/dgraph/cmd/{cert,conv,migrate,debuginfo},
upgrade/upgrade.go:104):

  cert      — self-signed CA + node/client cert issuance (TLS bootstrap)
  conv      — geo/JSON data conversion into RDF N-Quads
  migrate   — relational CSV dump -> RDF + schema (the SQL-migrate shape)
  debuginfo — collect a support bundle (metrics, state, traces, pprof-ish)
  upgrade   — on-disk layout migrations between framework versions
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
from typing import Dict, List, Optional


# ---------------------------------------------------------------------------
# cert (ref dgraph/cmd/cert: dgraph cert + dgraph cert ls)
# ---------------------------------------------------------------------------


def cert_create(
    out_dir: str,
    nodes: Optional[List[str]] = None,
    client: Optional[str] = None,
    days: int = 365,
) -> Dict[str, str]:
    """Create a CA (if absent) and node/client certs signed by it, using
    the system openssl (stdlib has no X.509 issuance). Layout matches the
    reference's tls dir: ca.{crt,key}, node.{crt,key}, client.<name>.*"""
    os.makedirs(out_dir, exist_ok=True)
    made = {}

    def run(*cmd):
        subprocess.run(cmd, check=True, capture_output=True)

    ca_key = os.path.join(out_dir, "ca.key")
    ca_crt = os.path.join(out_dir, "ca.crt")
    if not os.path.exists(ca_crt):
        run("openssl", "genrsa", "-out", ca_key, "2048")
        run(
            "openssl", "req", "-x509", "-new", "-key", ca_key,
            "-subj", "/CN=dgraph-tpu CA", "-days", str(days), "-out", ca_crt,
        )
        made["ca"] = ca_crt

    def issue(name: str, cn: str):
        key = os.path.join(out_dir, f"{name}.key")
        csr = os.path.join(out_dir, f"{name}.csr")
        crt = os.path.join(out_dir, f"{name}.crt")
        run("openssl", "genrsa", "-out", key, "2048")
        run("openssl", "req", "-new", "-key", key, "-subj", f"/CN={cn}", "-out", csr)
        run(
            "openssl", "x509", "-req", "-in", csr, "-CA", ca_crt,
            "-CAkey", ca_key, "-CAcreateserial", "-days", str(days),
            "-out", crt,
        )
        os.unlink(csr)
        made[name] = crt

    for node in nodes or []:
        issue("node", node)
    if client:
        issue(f"client.{client}", client)
    return made


def cert_ls(out_dir: str) -> List[dict]:
    out = []
    for f in sorted(os.listdir(out_dir)):
        if not f.endswith(".crt"):
            continue
        path = os.path.join(out_dir, f)
        got = subprocess.run(
            ["openssl", "x509", "-in", path, "-noout", "-subject", "-enddate"],
            capture_output=True,
            text=True,
        )
        out.append({"file": f, "info": got.stdout.strip()})
    return out


# ---------------------------------------------------------------------------
# conv (ref dgraph/cmd/conv: geo file -> RDF)
# ---------------------------------------------------------------------------


def conv_geojson(path: str, geopred: str = "loc") -> List[str]:
    """GeoJSON FeatureCollection -> RDF n-quads (ref conv/run.go)."""
    with open(path) as f:
        doc = json.load(f)
    feats = doc.get("features", [])
    rdf = []
    for i, feat in enumerate(feats, start=1):
        subj = f"_:f{i}"
        geom = feat.get("geometry")
        if geom:
            rdf.append(
                f'{subj} <{geopred}> "{json.dumps(geom).replace(chr(34), chr(39))}"^^<geo:geojson> .'
            )
        for k, v in (feat.get("properties") or {}).items():
            if v is None:
                continue
            sv = str(v).replace('"', "'")
            rdf.append(f'{subj} <{k}> "{sv}" .')
    return rdf


def conv_json(path: str) -> List[str]:
    """Flat JSON array -> RDF (each object one blank node)."""
    with open(path) as f:
        rows = json.load(f)
    rdf = []
    for i, row in enumerate(rows, start=1):
        for k, v in row.items():
            if v is None:
                continue
            sv = str(v).replace('"', "'")
            rdf.append(f'_:r{i} <{k}> "{sv}" .')
    return rdf


# ---------------------------------------------------------------------------
# migrate (ref dgraph/cmd/migrate: SQL -> dgraph)
# ---------------------------------------------------------------------------


def migrate_csv(
    tables: Dict[str, str],
    fk: Optional[Dict[str, tuple]] = None,
) -> tuple:
    """Relational CSV tables -> (schema_text, rdf_lines).

    tables: {table_name: csv_path} with a header row; a column named `id`
    is the row key. fk: {(table, column): target_table} turns that column
    into a uid edge (the reference's foreign-key mapping). Values are
    typed by sniffing (int/float/string)."""
    import csv

    fk = fk or {}
    schema: Dict[str, str] = {}
    rdf: List[str] = []

    def blank(tbl, rid):
        return f"_:{tbl}.{rid}"

    for tbl, path in tables.items():
        with open(path) as f:
            rows = list(csv.DictReader(f))
        for row in rows:
            rid = row.get("id") or str(rows.index(row) + 1)
            subj = blank(tbl, rid)
            rdf.append(f'{subj} <dgraph.type> "{tbl}" .')
            for col, val in row.items():
                if col == "id" or val in (None, ""):
                    continue
                pred = f"{tbl}.{col}"
                target = fk.get((tbl, col))
                if target:
                    rdf.append(f"{subj} <{pred}> {blank(target, val)} .")
                    schema[pred] = f"{pred}: [uid] ."
                    continue
                try:
                    int(val)
                    schema.setdefault(pred, f"{pred}: int @index(int) .")
                    rdf.append(f'{subj} <{pred}> "{val}"^^<xs:int> .')
                except ValueError:
                    try:
                        float(val)
                        schema.setdefault(pred, f"{pred}: float .")
                        rdf.append(f'{subj} <{pred}> "{val}"^^<xs:float> .')
                    except ValueError:
                        schema.setdefault(
                            pred, f"{pred}: string @index(term) ."
                        )
                        sv = str(val).replace('"', "'")
                        rdf.append(f'{subj} <{pred}> "{sv}" .')
    return "\n".join(sorted(schema.values())), rdf


# ---------------------------------------------------------------------------
# debuginfo (ref dgraph/cmd/debuginfo: collect a support archive)
# ---------------------------------------------------------------------------


def debuginfo(engine, out_dir: str) -> str:
    """Collect state/metrics/traces/schema into a bundle dir; returns the
    path (the reference archives pprof profiles + /state + logs)."""
    from dgraph_tpu_torch.utils.observe import METRICS, TRACER

    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    bundle = os.path.join(out_dir, f"debuginfo_{stamp}")
    os.makedirs(bundle, exist_ok=True)
    with open(os.path.join(bundle, "metrics.prom"), "w") as f:
        f.write(METRICS.render())
    with open(os.path.join(bundle, "traces.json"), "w") as f:
        json.dump(TRACER.recent(500), f, indent=1)
    with open(os.path.join(bundle, "state.json"), "w") as f:
        json.dump(
            {
                "maxTxnTs": engine.zero.max_assigned,
                "maxUID": engine.zero._max_uid,
                "predicates": engine.schema.predicates(),
            },
            f,
            indent=1,
        )
    from dgraph_tpu_torch.admin.export import _schema_line

    with open(os.path.join(bundle, "schema.txt"), "w") as f:
        for p in engine.schema.predicates():
            f.write(_schema_line(engine.schema.get(p)) + "\n")
    import sys as _sys
    import threading as _threading

    with open(os.path.join(bundle, "goroutines.txt"), "w") as f:
        for tid, frame in _sys._current_frames().items():
            name = next(
                (t.name for t in _threading.enumerate() if t.ident == tid),
                str(tid),
            )
            f.write(f"--- thread {name} ---\n")
            import traceback as _tb

            _tb.print_stack(frame, file=f)
    return bundle


# ---------------------------------------------------------------------------
# upgrade (ref upgrade/upgrade.go:104: versioned on-disk migrations)
# ---------------------------------------------------------------------------

LAYOUT_VERSION = 2  # round-2 layout: split-capable rollup records

_MIGRATIONS = {}


def _migration(frm: int):
    def deco(fn):
        _MIGRATIONS[frm] = fn
        return fn

    return deco


@_migration(1)
def _v1_to_v2(data_dir: str):
    """v1 rollup records lack the split-starts tail; decode_record treats
    the missing tail as 'no splits', so the upgrade is a no-op rewrite of
    the version marker. (Shape of the reference's change-tracked upgrades:
    each step is idempotent and bumps the marker.)"""
    return


def layout_version(data_dir: str) -> int:
    path = os.path.join(data_dir, "VERSION")
    if not os.path.exists(path):
        return 1
    with open(path) as f:
        return int(f.read().strip() or 1)


def upgrade(data_dir: str) -> List[int]:
    """Run pending on-disk migrations; returns the steps applied."""
    cur = layout_version(data_dir)
    applied = []
    while cur < LAYOUT_VERSION:
        step = _MIGRATIONS.get(cur)
        if step is None:
            raise RuntimeError(f"no migration from layout v{cur}")
        step(data_dir)
        cur += 1
        applied.append(cur)
        with open(os.path.join(data_dir, "VERSION"), "w") as f:
            f.write(str(cur))
    return applied
