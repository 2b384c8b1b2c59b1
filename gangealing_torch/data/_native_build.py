"""Atomic on-demand g++ builds of the native helpers.

The port's own copy of gangealing_tpu/data/_native_build.py. Compiling
straight to the target .so races when several processes start together:
one process can dlopen a half-written ELF, or the link step can clobber a
file another process is mid-dlopen on. Each process compiles to its own
temp file and os.replace()s it into place (atomic on POSIX), so concurrent
builds produce identical results and readers only ever see a complete
library.
"""

import os
import subprocess
from typing import Sequence


def build_shared_lib(srcs: Sequence[str], so: str,
                     extra_flags: Sequence[str] = ()) -> str:
    """Build ``so`` from ``srcs`` if missing or older than any source.
    Safe to call concurrently from multiple processes."""
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.check_call(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             *srcs, "-o", tmp, *extra_flags])
        os.replace(tmp, so)  # atomic: readers never see a partial .so
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return so
