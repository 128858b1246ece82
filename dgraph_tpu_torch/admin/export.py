"""Export: full-database dump to RDF or JSON plus schema.

Mirrors dgraph/worker/export.go (export:589, exportInternal:775):
stream every data key at a read ts, emit N-Quads (or JSON objects) plus the
schema file; gzip output files like the reference's .rdf.gz/.schema.gz.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Optional, TextIO

from dgraph_tpu_torch.types.types import TypeID
from dgraph_tpu_torch.x import keys
from dgraph_tpu_torch.posting.lists import LocalCache


def _rdf_literal(val, tid: TypeID) -> str:
    from dgraph_tpu_torch.types.types import Val

    v = val.value
    if tid == TypeID.INT:
        return f'"{v}"^^<xs:int>'
    if tid == TypeID.FLOAT:
        return f'"{v}"^^<xs:float>'
    if tid == TypeID.BOOL:
        return f'"{"true" if v else "false"}"^^<xs:boolean>'
    if tid == TypeID.DATETIME:
        return f'"{v.isoformat()}"^^<xs:dateTime>'
    if tid == TypeID.GEO:
        j = json.dumps(v, separators=(",", ":")).replace("\\", "\\\\").replace(
            '"', '\\"'
        )
        return f'"{j}"^^<geo:geojson>'
    if tid == TypeID.VFLOAT:
        arr = json.dumps([float(x) for x in v])
        return f'"{arr}"^^<float32vector>'
    s = str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return f'"{s}"'


def _schema_line(su) -> str:
    tname = {
        TypeID.DEFAULT: "default",
        TypeID.STRING: "string",
        TypeID.INT: "int",
        TypeID.FLOAT: "float",
        TypeID.BOOL: "bool",
        TypeID.DATETIME: "datetime",
        TypeID.GEO: "geo",
        TypeID.UID: "uid",
        TypeID.PASSWORD: "password",
        TypeID.VFLOAT: "float32vector",
    }.get(su.value_type, "default")
    t = f"[{tname}]" if su.is_list else tname
    directives = []
    if su.tokenizers or su.vector_specs:
        toks = list(su.tokenizers)
        for vs in su.vector_specs:
            opts = ",".join(f'{k}:"{v}"' for k, v in vs.options.items())
            toks.append(f"{vs.name}({opts})")
        directives.append(f"@index({', '.join(toks)})")
    if su.directive_reverse:
        directives.append("@reverse")
    if su.count:
        directives.append("@count")
    if su.upsert:
        directives.append("@upsert")
    if su.lang:
        directives.append("@lang")
    if su.unique:
        directives.append("@unique")
    d = (" " + " ".join(directives)) if directives else ""
    return f"{su.predicate}: {t}{d} ."


def export(
    server,
    out_dir: str,
    fmt: str = "rdf",
    read_ts: Optional[int] = None,
    compress: bool = True,
) -> dict:
    """Dump data + schema; returns {'data': path, 'schema': path, 'nquads': n}."""
    os.makedirs(out_dir, exist_ok=True)
    ts = read_ts if read_ts is not None else server.zero.read_ts()
    cache = LocalCache(server.kv, ts, mem=getattr(server, "mem", None))

    ext = "rdf" if fmt == "rdf" else "json"
    data_path = os.path.join(out_dir, f"export.{ext}" + (".gz" if compress else ""))
    schema_path = os.path.join(out_dir, "export.schema" + (".gz" if compress else ""))
    opener = (lambda p: gzip.open(p, "wt")) if compress else (lambda p: open(p, "w"))

    n = 0
    with opener(data_path) as f:
        if fmt == "json":
            f.write("[\n")
        first_obj = True
        for pred in server.schema.predicates():
            su = server.schema.get(pred)
            for k, _, _ in server.kv.iterate(keys.DataPrefix(pred), ts):
                pk = keys.parse_key(k)
                subj = f"<{hex(pk.uid)}>"
                if su.value_type == TypeID.UID:
                    for tgt in cache.uids(k):
                        if fmt == "rdf":
                            f.write(f"{subj} <{pred}> <{hex(int(tgt))}> .\n")
                        else:
                            _json_row(
                                f,
                                {"uid": hex(pk.uid), pred: [{"uid": hex(int(tgt))}]},
                                first_obj,
                            )
                            first_obj = False
                        n += 1
                for p in cache.values(k):
                    val = p.val()
                    if fmt == "rdf":
                        lang = f"@{p.lang}" if p.lang else ""
                        facets = ""
                        if p.facets:
                            fparts = ", ".join(
                                f"{fk}={fv.value}"
                                for fk, fv in p.get_facets().items()
                            )
                            facets = f" ({fparts})"
                        f.write(
                            f"{subj} <{pred}> "
                            f"{_rdf_literal(val, p.value_type)}{lang}{facets} .\n"
                        )
                    else:
                        _json_row(
                            f,
                            {"uid": hex(pk.uid), pred: _jsonable(val)},
                            first_obj,
                        )
                        first_obj = False
                    n += 1
        if fmt == "json":
            f.write("\n]\n")

    with opener(schema_path) as f:
        for pred in server.schema.predicates():
            f.write(_schema_line(server.schema.get(pred)) + "\n")
        for tname in server.schema.types():
            tu = server.schema.get_type(tname)
            fields = "\n  ".join(tu.fields)
            f.write(f"type {tu.name} {{\n  {fields}\n}}\n")

    return {"data": data_path, "schema": schema_path, "nquads": n, "ts": ts}


def _json_row(f: TextIO, obj: dict, first: bool):
    if not first:
        f.write(",\n")
    f.write(json.dumps(obj))


def _jsonable(val):
    import datetime as _dt

    x = val.value
    if isinstance(x, _dt.datetime):
        return x.isoformat()
    if val.tid == TypeID.VFLOAT:
        return [float(v) for v in x]
    from decimal import Decimal

    if isinstance(x, Decimal):
        return float(x)
    return x
