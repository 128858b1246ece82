"""The benchmark of `dgraph_tpu_torch` on an NVIDIA H100 (see README.md).

Nothing here imports JAX or the JAX package; the check in `isolation.py`
holds every run to that.
"""
