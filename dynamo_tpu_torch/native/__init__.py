"""Native (C++) host components of the router, loaded with ctypes.

Port of `dynamo_tpu/native/__init__.py` (the port keeps its own copy of
each source). These are host code, not kernels: each component builds at
first use with the system toolchain (`g++ -O3 -shared -fPIC -std=c++17`)
into `_build/dynamo_tpu_torch/<source-hash>/lib<name>.so` at the root of
the checkout, beside the CUDA kernels of `engine/cuda_build.py`. The
build is keyed by a hash of the source and the flags (an edited source
never loads a stale library) and written to a temporary file that is
renamed into place, so processes that start cold together never load a
half-written library. Without a compiler, or with `DYN_NATIVE=0`, callers
serve the pure-Python implementation, with the same results (randomized
differential tests enforce it).
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

logger = logging.getLogger(__name__)

_DIR = Path(__file__).parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build" / \
    "dynamo_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib_cache: dict[str, object] = {}
# name -> seconds the g++ build of this process took (absent: loaded a
# library an earlier process built, or never built)
build_seconds: dict[str, float] = {}


def library_path(name: str) -> Path:
    """Where ``<name>.cpp`` builds: keyed by a hash of the source and the
    compiler flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((_DIR / f"{name}.cpp").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def is_built(name: str) -> bool:
    return library_path(name).exists()


def build_and_load(name: str):
    """Compile ``<name>.cpp`` unless its library is built, and dlopen it.
    Returns the ctypes CDLL, or None when building isn't possible."""
    import ctypes

    with _lock:
        if name in _lib_cache:
            return _lib_cache[name]
        so = library_path(name)
        try:
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = ["g++", *CXX_FLAGS, str(_DIR / f"{name}.cpp"),
                       "-o", str(tmp)]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=120)
                if proc.returncode != 0:
                    logger.warning("native build failed for %s: %s", name,
                                   proc.stderr[-500:])
                    _lib_cache[name] = None
                    return None
                os.replace(tmp, so)
                build_seconds[name] = time.perf_counter() - t0
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native %s unavailable: %r", name, e)
            _lib_cache[name] = None
            return None
        _lib_cache[name] = lib
        return lib


def native_enabled() -> bool:
    return os.environ.get("DYN_NATIVE", "1").lower() not in (
        "0", "false", "no")
