"""Superflags: grouped `k=v; k2=v2` option strings.

Mirrors dgraph/x/flags.go (NewSuperFlag / GetString etc.): the
reference's CLIs take option groups like
  --badger "compression=zstd; numgoroutines=8"
  --security "whitelist=10.0.0.0/8; token=abc"
with defaults merged and unknown keys rejected. Same contract here for
the alpha/bulk CLIs (--storage, --security, --trace, --raft, --limit).
"""

from __future__ import annotations

from typing import Dict, Optional


class SuperFlagError(ValueError):
    pass


class SuperFlag:
    def __init__(self, spec: str = "", defaults: str = ""):
        """spec: user input "k=v; k2=v2"; defaults defines the allowed
        keys AND their default values (like NewSuperFlag(...).MergeAndCheck)."""
        self._defaults = self._parse(defaults)
        given = self._parse(spec)
        unknown = set(given) - set(self._defaults)
        if self._defaults and unknown:
            raise SuperFlagError(
                f"unknown superflag option(s) {sorted(unknown)}; "
                f"allowed: {sorted(self._defaults)}"
            )
        self._vals: Dict[str, str] = dict(self._defaults)
        self._vals.update(given)

    @staticmethod
    def _parse(s: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for part in (s or "").split(";"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise SuperFlagError(f"superflag option {part!r} needs k=v")
            k, v = part.split("=", 1)
            out[k.strip().lower().replace("_", "-")] = v.strip()
        return out

    def get_string(self, key: str, default: str = "") -> str:
        return self._vals.get(key.lower().replace("_", "-"), default)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get_string(key, "")
        if v == "":
            return default
        if v.lower() in ("true", "1", "yes", "on"):
            return True
        if v.lower() in ("false", "0", "no", "off"):
            return False
        raise SuperFlagError(f"superflag {key}={v!r} is not a boolean")

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get_string(key, "")
        if v == "":
            return default
        try:
            return int(v)
        except ValueError as e:
            raise SuperFlagError(f"superflag {key}={v!r} is not an int") from e

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get_string(key, "")
        if v == "":
            return default
        try:
            return float(v)
        except ValueError as e:
            raise SuperFlagError(
                f"superflag {key}={v!r} is not a float"
            ) from e

    def as_dict(self) -> Dict[str, str]:
        return dict(self._vals)


# the alpha CLI's groups (subset of dgraph alpha's; ref worker/config.go)
STORAGE_DEFAULTS = "backend=mem; encryption-key-file=; memtable-mb=8"
SECURITY_DEFAULTS = "token=; whitelist="
TRACE_DEFAULTS = "jaeger=; datadog=; ratio=0.01; sink-file="
LIMIT_DEFAULTS = (
    "query-edge=1000000; mutations=allow; max-retries=-1; "
    "max-pending-queries=10000"
)
RAFT_DEFAULTS = "compact-every=1024; election-lo-ms=150; election-hi-ms=300"
