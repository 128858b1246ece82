"""Protocol buffers for the public client API.

api_pb2 is generated from api.proto by protoc at first import (and cached
beside the .proto): checking generated code in would pin a protobuf
runtime version, and the baked toolchain already has protoc.
"""

import importlib
import os
import subprocess
import sys

_HERE = os.path.dirname(__file__)


def _ensure_generated():
    gen = os.path.join(_HERE, "api_pb2.py")
    proto = os.path.join(_HERE, "api.proto")
    if not os.path.exists(gen) or os.path.getmtime(gen) < os.path.getmtime(
        proto
    ):
        subprocess.run(
            ["protoc", f"-I{_HERE}", f"--python_out={_HERE}", proto],
            check=True,
        )


def load_api_pb2():
    # as this package's own module: the reference imports a top-level
    # `api_pb2` from its directory, which a process that holds both
    # packages would resolve to whichever loaded first
    _ensure_generated()
    return importlib.import_module(__name__ + ".api_pb2")
