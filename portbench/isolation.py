"""The check that a run loaded no JAX: neither `jax`, `jaxlib` nor `flax`,
nor the JAX package of this repository, by whole top-level module name
(the port's package name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dgraph_tpu")


def loaded_forbidden(modules=None) -> list:
    mods = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in mods} & set(FORBIDDEN))
