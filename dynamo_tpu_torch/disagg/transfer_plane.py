"""The KV transfer plane between two processes on one card: CUDA IPC.

The port's counterpart of `dynamo_tpu/disagg/transfer_plane.py`, which
stages a device array on a `jax.experimental.transfer` server for the
peer to pull. Here the peer maps the producer's staging buffer into its
own address space and copies it on the card; no byte touches the host.

Protocol, on the prefill worker's `kv_pull` endpoint
(`disagg/handlers.py`):

1. The decode worker asks `{"transfer_id", "stage": true, "plane":
   "cuda_ipc"}`. The producer gathers the pinned pages into a staging
   buffer on its card (one gather launch, `engine.read_kv_pages_device`,
   which returns once the gather has completed), exports a
   `cudaIpcGetMemHandle` of the allocation that holds the buffer, releases
   the pages (the buffer is an independent copy) and replies one
   descriptor frame `{"plane": {"kind", "handle", "offset", "shape",
   "dtype", "pid"}}`. An IPC handle names the base of the caching
   allocator's segment, not the tensor, so the descriptor carries the
   buffer's byte offset in it (`cuMemGetAddressRange`).
2. The consumer opens the handle (`cudaIpcOpenMemHandle`), copies the
   buffer into its own memory on the card, synchronizes, closes the
   handle, and acks with `{"transfer_id", "release": true}`; its engine
   then imports the copy through K3 when the request is admitted. The
   copy frees the producer's buffer at once, however long the request
   waits for admission.
3. The producer keeps the buffer alive until that ack, so it is never
   reused under the consumer's copy, or until `ttl` seconds have passed
   (checked at each publish and release).

`cudaIpcOpenMemHandle` refuses a handle from its own process: in one
process the handlers' same-process registry serves instead, and a
descriptor from this process is refused here. The CUDA runtime
(libcudart) and libcuda are called through ctypes, as
`engine/cuda_build.py` loads the kernels. `DYN_KV_PLANE=0` turns the
plane off on either side (the reference's one switch); a machine without
a card never has it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import os
import threading
import time
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)

PLANE_KIND = "cuda_ipc"
IPC_HANDLE_BYTES = 64
_IPC_LAZY_ENABLE_PEER_ACCESS = 1
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class _IpcHandle(ctypes.Structure):
    # bytes, not c_char: a c_char array reads back cut at its first NUL
    _fields_ = [("reserved", ctypes.c_ubyte * IPC_HANDLE_BYTES)]


def _load(names: list[str]) -> Optional[ctypes.CDLL]:
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _cudart_candidates() -> list[str]:
    """Where the CUDA runtime may be: already loaded by torch (found by
    soname), the toolkit, or the wheel's nvidia package beside torch."""
    names = []
    try:
        # the copy torch loaded, first: one runtime for the whole process
        with open("/proc/self/maps") as f:
            names += sorted({line.split()[-1] for line in f
                             if "libcudart.so" in line})
    except OSError:
        pass
    names += ["libcudart.so", "libcudart.so.13", "libcudart.so.12",
              "libcudart.so.11.0"]
    found = ctypes.util.find_library("cudart")
    if found:
        names.append(found)
    names += [str(p) for p in Path("/usr/local/cuda/lib64").glob(
        "libcudart.so*")]
    site = Path(torch.__file__).resolve().parents[1]
    names += [str(p) for p in (site / "nvidia").glob(
        "cuda_runtime/lib/libcudart.so*")]
    return names


_libs: dict[str, Optional[ctypes.CDLL]] = {}
_libs_lock = threading.Lock()


def _rt() -> ctypes.CDLL:
    """The CUDA runtime library, its IPC functions typed."""
    with _libs_lock:
        if "rt" not in _libs:
            lib = _load(_cudart_candidates())
            if lib is not None:
                lib.cudaIpcGetMemHandle.argtypes = [
                    ctypes.POINTER(_IpcHandle), ctypes.c_void_p]
                lib.cudaIpcOpenMemHandle.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), _IpcHandle,
                    ctypes.c_uint]
                lib.cudaIpcCloseMemHandle.argtypes = [ctypes.c_void_p]
                lib.cudaSetDevice.argtypes = [ctypes.c_int]
                lib.cudaGetErrorString.argtypes = [ctypes.c_int]
                lib.cudaGetErrorString.restype = ctypes.c_char_p
            _libs["rt"] = lib
        lib = _libs["rt"]
    if lib is None:
        raise RuntimeError("kv plane: the CUDA runtime library was not found")
    return lib


def _libcuda() -> ctypes.CDLL:
    """libcuda, for the allocation range of a pointer."""
    with _libs_lock:
        if "drv" not in _libs:
            lib = _load(["libcuda.so.1", "libcuda.so"])
            if lib is not None:
                lib.cuMemGetAddressRange_v2.argtypes = [
                    ctypes.POINTER(ctypes.c_uint64),
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_uint64]
            _libs["drv"] = lib
        lib = _libs["drv"]
    if lib is None:
        raise RuntimeError("kv plane: libcuda was not found")
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _rt().cudaGetErrorString(err).decode()
        raise RuntimeError(f"kv plane: {what} failed: {msg} ({err})")


def _bind(device: torch.device) -> None:
    """Make `device`'s primary context current on this thread (the
    libcuda call below needs one; a worker thread may have none yet)."""
    _check(_rt().cudaSetDevice(device.index or 0), "cudaSetDevice")


def plane_enabled(device: Optional[torch.device] = None) -> bool:
    """The plane is on unless DYN_KV_PLANE=0, and only on a card (`device`
    a CUDA device, when given) whose CUDA libraries this process can
    load."""
    if os.environ.get("DYN_KV_PLANE", "1") == "0" \
            or (device is not None and device.type != "cuda") \
            or not torch.cuda.is_available():
        return False
    try:
        _rt()
        _libcuda()
    except RuntimeError:
        return False
    return True


def _allocation_range(ptr: int) -> tuple[int, int]:
    base, size = ctypes.c_uint64(), ctypes.c_size_t()
    err = _libcuda().cuMemGetAddressRange_v2(ctypes.byref(base),
                                            ctypes.byref(size), ptr)
    if err != 0:
        raise RuntimeError(f"kv plane: cuMemGetAddressRange failed ({err})")
    return base.value, size.value


class _DeviceMemory:
    """Raw device bytes for `torch.as_tensor` (`__cuda_array_interface__`),
    without taking ownership."""

    def __init__(self, ptr: int, nbytes: int) -> None:
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


class TransferPlane:
    """One per process: the producer's staged buffers and the consumer's
    pull."""

    def __init__(self, ttl: float = 60.0) -> None:
        self.ttl = ttl
        self._staged: dict[str, tuple[torch.Tensor, float]] = {}
        self._lock = threading.Lock()

    @property
    def staged(self) -> int:
        """Buffers waiting for their consumer's ack."""
        with self._lock:
            return len(self._staged)

    def publish(self, transfer_id: str, buf: torch.Tensor) -> dict:
        """Producer: export `buf` (on the card, its writes complete) and
        keep it alive until `release(transfer_id)` or the TTL. Returns the
        descriptor frame's body."""
        if buf.device.type != "cuda" or not buf.is_contiguous():
            raise ValueError("kv plane: a contiguous CUDA tensor is staged")
        self._reap()
        _bind(buf.device)
        base, size = _allocation_range(buf.data_ptr())
        handle = _IpcHandle()
        _check(_rt().cudaIpcGetMemHandle(ctypes.byref(handle), base),
               "cudaIpcGetMemHandle")
        offset = buf.data_ptr() - base
        if offset + buf.nbytes > size:
            raise RuntimeError("kv plane: the staged buffer leaves its "
                               "allocation")
        with self._lock:
            self._staged[transfer_id] = (buf, time.monotonic() + self.ttl)
        return {"kind": PLANE_KIND, "handle": bytes(handle.reserved),
                "offset": offset, "shape": list(buf.shape),
                "dtype": str(buf.dtype).removeprefix("torch."),
                "pid": os.getpid()}

    def release(self, transfer_id: str) -> bool:
        """Producer: free a staged buffer (the consumer's ack); idempotent.
        True when it was still staged."""
        with self._lock:
            found = self._staged.pop(transfer_id, None) is not None
        self._reap()
        return found

    def _reap(self) -> None:
        now = time.monotonic()
        with self._lock:
            expired = [t for t, (_, dl) in self._staged.items() if dl <= now]
            for tid in expired:
                del self._staged[tid]
        for tid in expired:
            logger.warning("kv plane: staged transfer %s expired unpulled",
                           tid)

    def pull(self, desc: dict, device: torch.device) -> torch.Tensor:
        """Consumer: map the producer's buffer, copy it into a new tensor
        on `device`, synchronize and unmap. Blocking (call from a
        thread)."""
        if desc.get("kind") != PLANE_KIND:
            raise ValueError(f"kv plane: not a {PLANE_KIND} descriptor")
        if int(desc["pid"]) == os.getpid():
            raise ValueError("kv plane: a CUDA IPC handle cannot be opened "
                             "in the process that exported it")
        dtype = _DTYPES[desc["dtype"]]
        shape = [int(x) for x in desc["shape"]]
        out = torch.empty(shape, dtype=dtype, device=device)
        raw = bytes(desc["handle"])
        if len(raw) != IPC_HANDLE_BYTES:
            raise ValueError("kv plane: malformed IPC handle")
        handle = _IpcHandle.from_buffer_copy(raw)
        _bind(device)
        ptr = ctypes.c_void_p()
        _check(_rt().cudaIpcOpenMemHandle(ctypes.byref(ptr), handle,
                                          _IPC_LAZY_ENABLE_PEER_ACCESS),
               "cudaIpcOpenMemHandle")
        try:
            src = torch.as_tensor(
                _DeviceMemory(ptr.value + int(desc["offset"]), out.nbytes),
                device=device)
            out.view(torch.uint8).view(-1).copy_(src)
            torch.cuda.current_stream(device).synchronize()
        finally:
            _check(_rt().cudaIpcCloseMemHandle(ptr), "cudaIpcCloseMemHandle")
        return out


_plane: Optional[TransferPlane] = None


def get_plane() -> TransferPlane:
    global _plane
    if _plane is None:
        _plane = TransferPlane()
    return _plane
