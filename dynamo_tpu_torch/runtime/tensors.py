"""Host tensors as raw bytes: the wire and tier format of KV blocks.

The reference moves KV as numpy arrays and reads bf16 through
`ml_dtypes`, which ships with jax; the port keeps torch tensors and
names a dtype by its numpy name ("bfloat16", "float32"), so its frames
(the disagg `kv_pull` wire, the KVBM `kvbm_pull` frames) and its disk
tier's files hold the reference's bytes and read the reference's.
"""

from __future__ import annotations

import warnings

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's numpy name: "bfloat16", not "torch.bfloat16"."""
    return str(dtype).removeprefix("torch.")


def tensor_bytes(t: torch.Tensor) -> tuple[bytes, list[int], str]:
    """A host tensor as the reference's frame fields: its bytes, its
    shape and its dtype's numpy name."""
    t = t.contiguous()
    raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return raw, list(t.shape), dtype_name(t.dtype)


def tensor_from(raw: bytes, shape: list[int], dtype: str) -> torch.Tensor:
    """The inverse of `tensor_bytes` (and of the reference's
    `_bf16_bytes`): a host tensor over the bytes, read only."""
    dt = DTYPES[dtype]
    if not raw:
        return torch.empty(shape, dtype=dt)
    with warnings.catch_warnings():
        # the bytes are immutable; nothing writes through the view
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(raw, dtype=dt).reshape(shape)
