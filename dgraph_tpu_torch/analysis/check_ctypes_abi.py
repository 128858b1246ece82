"""ctypes ABI cross-checker: C++ `extern "C"` exports vs Python DECLS.

The native kernels are bound by hand-maintained ctypes declarations
(`dgraph_tpu_torch/native/__init__.py` DECLS). Nothing at runtime validates
them: ctypes will happily call an `int64_t`-returning function with the
default `c_int` restype and hand back the low 32 bits — a decode count
or file offset past 2**31 silently corrupts memory downstream. This
checker re-derives the ABI from the C++ source on every lint run:

  undeclared-export — an exported (non-static) extern "C" function
    with no DECLS entry: it would be called with guessed types.
  stale-decl — a DECLS entry with no C++ export (renamed/removed).
  arity-mismatch — parameter count differs.
  arg-type-mismatch — width/signedness/pointer shape differs for a
    parameter (8-bit pointers are interchangeable: char*, uint8_t*).
  restype-mismatch — declared restype (None == void) does not match
    the C++ return type. This is the truncation class.

Both sides reduce to the same canonical descriptor:
(kind, bit width, signed, pointer depth). `void*` and `T**` compare by
pointer shape; signedness is ignored at 8 bits (byte buffers).
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from dgraph_tpu_torch.analysis.core import Source, Violation

NAME = "ctypes-abi"

# (kind, width, signed); kind "void" only for the void return type
_C_BASE = {
    "void": ("void", 0, False),
    "char": ("int", 8, True),
    "signed char": ("int", 8, True),
    "unsigned char": ("int", 8, False),
    "int8_t": ("int", 8, True),
    "uint8_t": ("int", 8, False),
    "short": ("int", 16, True),
    "unsigned short": ("int", 16, False),
    "int16_t": ("int", 16, True),
    "uint16_t": ("int", 16, False),
    "int": ("int", 32, True),
    "unsigned": ("int", 32, False),
    "unsigned int": ("int", 32, False),
    "int32_t": ("int", 32, True),
    "uint32_t": ("int", 32, False),
    "long long": ("int", 64, True),
    "unsigned long long": ("int", 64, False),
    "int64_t": ("int", 64, True),
    "uint64_t": ("int", 64, False),
    "size_t": ("int", 64, False),
    "float": ("float", 32, True),
    "double": ("float", 64, True),
}

Desc = Tuple[str, int, bool, int]  # (kind, width, signed, ptr_depth)


def _typedefs(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for m in re.finditer(r"\busing\s+(\w+)\s*=\s*([^;]+);", text):
        out[m.group(1)] = m.group(2).strip()
    for m in re.finditer(r"\btypedef\s+([^;]+?)\s+(\w+)\s*;", text):
        out[m.group(2)] = m.group(1).strip()
    return out


def _canon_c_type(raw: str, typedefs: Dict[str, str]) -> Optional[Desc]:
    t = raw.strip()
    for _ in range(8):  # resolve typedef chains
        base = t.replace("*", " ").replace("const", " ").strip()
        base = " ".join(base.split())
        if base in typedefs:
            t = t.replace(base, typedefs[base])
        else:
            break
    ptr = t.count("*")
    base = t.replace("*", " ").replace("const", " ").strip()
    base = " ".join(base.split())
    if base not in _C_BASE:
        return None
    kind, width, signed = _C_BASE[base]
    return (kind, width, signed, ptr)


def _extern_c_regions(text: str) -> str:
    """Concatenated bodies of `extern "C" { ... }` blocks (brace-matched)."""
    out = []
    for m in re.finditer(r'extern\s+"C"\s*\{', text):
        depth = 1
        i = m.end()
        start = i
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        out.append(text[start:i - 1])
    return "\n".join(out)


_FN_RE = re.compile(
    r"^(?P<quals>(?:static\s+|inline\s+)*)"
    r"(?P<ret>[A-Za-z_][\w ]*?[\w\*]\**)\s+"
    r"(?P<name>\w+)\s*\(",
    re.M,
)


def parse_cpp_exports(
    text: str,
) -> Dict[str, Tuple[str, List[str], int]]:
    """{name: (return_type, [param_types], line)} for non-static
    functions defined inside extern "C" blocks."""
    region = _extern_c_regions(text)
    # line numbers: map region offsets back via a search in `text`
    exports: Dict[str, Tuple[str, List[str], int]] = {}
    for m in _FN_RE.finditer(region):
        if "static" in m.group("quals"):
            continue
        name = m.group("name")
        ret = m.group("ret").strip()
        if ret in ("return", "else", "if", "while"):
            continue
        # capture the parameter list up to the matching ')'
        depth = 1
        i = m.end()
        while i < len(region) and depth:
            if region[i] == "(":
                depth += 1
            elif region[i] == ")":
                depth -= 1
            i += 1
        params_raw = region[m.end():i - 1]
        # a definition follows with '{'; prototypes (';') also accepted
        params: List[str] = []
        if params_raw.strip() not in ("", "void"):
            for part in _split_params(params_raw):
                # drop the trailing parameter name (if any)
                part = part.strip()
                pm = re.match(r"^(.*?)(\b\w+)?$", part, re.S)
                typ = (pm.group(1) or part).strip() if pm else part
                if not typ:  # unnamed parameter, e.g. "void*"
                    typ = part
                params.append(" ".join(typ.split()))
        # line number of the definition in the original text
        dm = re.search(
            rf"^\s*(?:[\w\* ]+?)\b{re.escape(name)}\s*\(", text, re.M
        )
        line = text.count("\n", 0, dm.start()) + 1 if dm else 1
        exports[name] = (ret, params, line)
    return exports


def _split_params(s: str) -> List[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return parts


# -- Python (ctypes) side ----------------------------------------------------

_CT_BASE = {
    ctypes.c_int8: ("int", 8, True),
    ctypes.c_uint8: ("int", 8, False),
    ctypes.c_char: ("int", 8, True),
    ctypes.c_int16: ("int", 16, True),
    ctypes.c_uint16: ("int", 16, False),
    ctypes.c_int32: ("int", 32, True),
    ctypes.c_uint32: ("int", 32, False),
    ctypes.c_int64: ("int", 64, True),
    ctypes.c_uint64: ("int", 64, False),
    ctypes.c_float: ("float", 32, True),
    ctypes.c_double: ("float", 64, True),
}


def canon_ctype(t) -> Optional[Desc]:
    """Canonical descriptor for a ctypes type (None == void)."""
    if t is None:
        return ("void", 0, False, 0)
    if t is ctypes.c_void_p:
        return ("void", 0, False, 1)
    if t is ctypes.c_char_p:
        return ("int", 8, True, 1)
    depth = 0
    while hasattr(t, "_type_") and not isinstance(t._type_, str):
        depth += 1
        t = t._type_
    if t in _CT_BASE:
        kind, width, signed = _CT_BASE[t]
        return (kind, width, signed, depth)
    # c_int/c_long resolve to one of the sized aliases above on every
    # supported platform; anything else is unknown
    return None


def _match(c: Desc, py: Desc) -> bool:
    ck, cw, cs, cp = c
    pk, pw, ps, pp = py
    if cp != pp:
        return False
    if cp > 0:
        # pointer: void* matches only void*; 8-bit pointees are
        # interchangeable (char* / uint8_t* byte buffers)
        if ck == "void" or pk == "void":
            return ck == pk
        if cw == 8 and pw == 8:
            return True
        return (ck, cw, cs) == (pk, pw, ps)
    if ck == "void" or pk == "void":
        return ck == pk
    return (ck, cw, cs) == (pk, pw, ps)


def _fmt(d: Optional[Desc]) -> str:
    if d is None:
        return "<unknown>"
    kind, width, signed, ptr = d
    if kind == "void":
        base = "void"
    else:
        base = f"{'' if signed else 'u'}{kind}{width}"
    return base + "*" * ptr


def check_abi(
    cpp_texts: Dict[str, str],
    decls: Dict[str, tuple],
    decl_path: str,
    decl_lines: Optional[Dict[str, int]] = None,
) -> List[Violation]:
    """Core comparison, parameterized so self-tests can feed synthetic
    sources. cpp_texts: {rel_path: source}; decls: name -> (restype,
    [argtypes]) with real ctypes objects."""
    out: List[Violation] = []
    decl_lines = decl_lines or {}
    exports: Dict[str, Tuple[str, List[str], int, str, Dict[str, str]]] = {}
    for rel, text in cpp_texts.items():
        tds = _typedefs(text)
        for name, (ret, params, line) in parse_cpp_exports(text).items():
            exports[name] = (ret, params, line, rel, tds)

    for name, (ret, params, line, rel, tds) in sorted(exports.items()):
        if name not in decls:
            out.append(Violation(
                NAME, "undeclared-export", rel, line,
                f"extern \"C\" {name} has no entry in native DECLS — "
                f"ctypes would guess int-sized types for it",
            ))
            continue
        restype, argtypes = decls[name]
        dline = decl_lines.get(name, 1)
        if len(params) != len(argtypes):
            out.append(Violation(
                NAME, "arity-mismatch", decl_path, dline,
                f"{name}: C++ takes {len(params)} args "
                f"({rel}:{line}), DECLS declares {len(argtypes)}",
            ))
            continue
        c_ret = _canon_c_type(ret, tds)
        py_ret = canon_ctype(restype)
        if c_ret is None or py_ret is None or not _match(c_ret, py_ret):
            out.append(Violation(
                NAME, "restype-mismatch", decl_path, dline,
                f"{name}: C++ returns {ret!r} ({_fmt(c_ret)}) but "
                f"restype is {_fmt(py_ret)} — an unset/narrow restype "
                f"truncates through ctypes' c_int default",
            ))
        for i, (cparam, pyt) in enumerate(zip(params, argtypes)):
            c_d = _canon_c_type(cparam, tds)
            py_d = canon_ctype(pyt)
            if c_d is None or py_d is None or not _match(c_d, py_d):
                out.append(Violation(
                    NAME, "arg-type-mismatch", decl_path, dline,
                    f"{name} arg {i}: C++ {cparam!r} ({_fmt(c_d)}) vs "
                    f"declared {_fmt(py_d)}",
                ))
    for name in sorted(decls):
        if name not in exports:
            out.append(Violation(
                NAME, "stale-decl", decl_path, decl_lines.get(name, 1),
                f"DECLS entry {name} has no extern \"C\" definition in "
                f"the native sources",
            ))
    return out


def check(sources: List[Source], root: str) -> List[Violation]:
    native_dir = os.path.join(root, "native")
    if not os.path.isdir(native_dir):
        return []
    cpp_texts: Dict[str, str] = {}
    for fn in sorted(os.listdir(native_dir)):
        if fn.endswith(".cpp"):
            with open(os.path.join(native_dir, fn), encoding="utf-8") as f:
                cpp_texts[f"native/{fn}"] = f.read()
    from dgraph_tpu_torch import native as native_mod

    decl_rel = "native/__init__.py"
    decl_lines: Dict[str, int] = {}
    init_path = os.path.join(native_dir, "__init__.py")
    if os.path.exists(init_path):
        with open(init_path, encoding="utf-8") as f:
            for i, ln in enumerate(f, 1):
                m = re.match(r'\s*"(\w+)":', ln)
                if m:
                    decl_lines.setdefault(m.group(1), i)
    return check_abi(
        cpp_texts, native_mod.DECLS, decl_rel, decl_lines
    )
