"""RDF response encoding: query results as N-Quads.

Mirrors dgraph/query/outputrdf.go (ToRDF: walk the SubGraph,
emit one triple per (uid, attr, value|target)): the alternative wire
format clients select with resp_format=RDF (pb.Request) or the HTTP
respFormat parameter. Value types render with the same literal
conventions the RDF loader accepts, so an exported result round-trips.
"""

from __future__ import annotations

import datetime
from typing import List

import numpy as np

from dgraph_tpu_torch.query.outputjson import encode_uid
from dgraph_tpu_torch.query.valuefmt import float_lit, rfc3339
from dgraph_tpu_torch.types.types import TypeID


def _literal(v) -> str:
    val = v.value
    if v.tid == TypeID.INT:
        return f'"{int(val)}"^^<xs:int>'
    if v.tid == TypeID.FLOAT:
        return f'"{float_lit(val)}"^^<xs:float>'
    if v.tid == TypeID.BOOL:
        return f'"{"true" if val else "false"}"^^<xs:boolean>'
    if v.tid == TypeID.DATETIME:
        # the SAME RFC3339 form the JSON encoders emit (valuefmt) — a
        # result exported as RDF round-trips through the loader with
        # the zone explicit instead of dropped
        s = (
            rfc3339(val)
            if isinstance(val, datetime.datetime)
            else str(val)
        )
        return f'"{s}"^^<xs:dateTime>'
    if v.tid == TypeID.VFLOAT:
        arr = np.asarray(val).tolist()
        return f'"{arr}"^^<xs:float32vector>'
    s = str(val).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'


def encode_rdf(nodes: List[object]) -> str:
    """ExecNode forest -> N-Quads text (one line per emitted triple)."""
    lines: List[str] = []
    seen = set()

    def walk(node):
        parent_uids = [int(u) for u in node.dest_uids]
        for c in node.children:
            attr = c.gq.alias or c.attr
            if c.gq.is_uid or c.gq.is_count or c.gq.aggregator:
                continue  # synthetic fields have no RDF form (ref outputrdf)
            if c.is_uid_pred:
                for i, pu in enumerate(parent_uids):
                    row = (
                        c.uid_matrix[i] if i < len(c.uid_matrix) else []
                    )
                    for tu in row:
                        tri = (pu, attr, int(tu))
                        if tri not in seen:
                            seen.add(tri)
                            lines.append(
                                f"<{encode_uid(pu)}> <{attr}> "
                                f"<{encode_uid(int(tu))}> ."
                            )
                walk(c)
            else:
                for pu in parent_uids:
                    for p in c.values.get(pu, []):
                        tri = (pu, attr, p.value)
                        if tri in seen:
                            continue
                        seen.add(tri)
                        lang = f"@{p.lang}" if p.lang else ""
                        lines.append(
                            f"<{encode_uid(pu)}> <{attr}> "
                            f"{_literal(p.val())}{lang} ."
                        )

    for node in nodes:
        if node is not None:
            walk(node)
    return "\n".join(lines) + ("\n" if lines else "")
