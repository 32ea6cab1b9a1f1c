"""Build and bind the port's hand-written CUDA kernels (csrc/*.cu).

Each source (headers it includes sit beside it as `*.cuh`) exports
`extern "C"` launchers that take raw device pointers
and a `cudaStream_t` and return a `cudaError_t`. At first use every
source is compiled by its own `nvcc -gencode arch=compute_90a,code=sm_90a
-shared` process — all started together — into
`_build/dynamo_tpu_torch/<source-hash>/lib<name>.so` beside the package
(a directory .gitignore lists), then loaded with ctypes. This needs
neither ninja nor Python headers where the kernels are built.

Every kernel is a `CudaKernel`: it counts the launches it made (a plain
integer, reset by `reset_launch_counts`) so a run can show that its main
path went through the kernels. A CUDA graph replays its kernels without
calling their wrappers, so `engine/graphs.py` keeps the counts honest
with `launch_counts` / `launch_delta` / `add_launches`: at capture it
records each kernel's launch delta and takes it back (a capture runs
nothing), and each replay adds it. A failed build raises with nvcc's stderr;
a refused launch raises with the CUDA error string. Nothing here is
imported lazily into a fallback: callers launch or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build" / \
    "dynamo_tpu_torch"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS: dict[str, "CudaKernel"] = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "dynamo_tpu_torch: nvcc not found (PATH or /usr/local/cuda); "
            "the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """Build directory keyed by the hash of every source and header and
    the flags, so an edited kernel never loads a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every registered kernel's source that is not built yet, one
    nvcc process per source, all running at once. Returns {name: ptxas
    log} for the sources built by this call."""
    out_dir = build_dir()
    with _build_lock:
        todo = [k for k in KERNELS.values()
                if not (out_dir / k.lib_name).exists()]
        if not todo:
            return {}
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for k in todo:
            tmp = out_dir / f"{k.lib_name}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
            procs.append((k, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failures = {}, []
        for k, tmp, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{k.source.name}: nvcc rc "
                                f"{proc.returncode}\n{stderr}{stdout}")
                continue
            os.replace(tmp, out_dir / k.lib_name)
            k.build_log = stderr
            logs[k.name] = stderr
        if failures:
            raise RuntimeError("dynamo_tpu_torch: kernel build failed:\n"
                               + "\n".join(failures))
        return logs


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    """{kernel name: launches so far}."""
    return {name: k.launches for name, k in KERNELS.items()}


def launch_delta(before: dict[str, int], after: dict[str, int]
                 ) -> dict[str, int]:
    """The launches each kernel made between two `launch_counts()`
    snapshots; kernels that made none are left out."""
    return {name: n - before.get(name, 0) for name, n in after.items()
            if n != before.get(name, 0)}


def add_launches(delta: dict[str, int], times: int = 1) -> None:
    """Add `times` × `delta` to the counts: a graph replay adds the
    launches its capture recorded (`times=-1` takes a capture's back)."""
    for name, n in delta.items():
        KERNELS[name].launches += times * n


class CudaKernel:
    """One kernel's C launcher, loaded from its own shared library."""

    def __init__(self, name: str, argtypes: list) -> None:
        self.name = name
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        KERNELS[name] = self

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    @property
    def lib_name(self) -> str:
        return f"lib{self.name}.so"

    def _load(self) -> ctypes.CDLL:
        path = build_dir() / self.lib_name
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        self._lib = lib
        return lib

    def __call__(self, *args) -> None:
        """Launch on the caller's stream (passed in `args`); raise if the
        launch was refused. Counts only launches that were accepted."""
        lib = self._lib or self._load()
        err = getattr(lib, f"{self.name}_launch")(*args)
        if err != 0:
            msg = lib.error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: {msg}")
        self.launches += 1
