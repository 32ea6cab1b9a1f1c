"""Weight quantization for the serving engine, in PyTorch.

Port of `dynamo_tpu/engine/quant.py`: per-output-channel symmetric int8
(and nibble-packed int4) weights, `qm` dispatch, and the model-level pass.
Scheme, as the reference's: for a weight W of logical shape (K, N), scale
s = absmax over K · f32(1/qmax) with shape (1, N) fp32 (`int4_mm.recip32`),
q = round(W / s) clipped to ±qmax (127 or 7). Embeddings, norms and
biases stay unquantized.

Three modes, as `TpuEngineConfig.quantize`:
- "int8": W8A16 — `x @ q.to(x.dtype)` then `* s`. A plain PyTorch product
  (the reference leaves it to XLA); it converts the weights every call.
- "w8a8": per-row int8 activations, exact int32 product, epilogue
  `(y·sx)·s` — K5 `int4_mm.w8a8_matmul`.
- "int4": the same over nibble-packed weights — K6 `int4_mm.int4_matmul`.
The lm_head is int8 at act_bits 16 in every mode, and only when its vocab
is at most LM_HEAD_QUANT_MAX_VOCAB.

Layout, the one difference from the reference: `QTensor.q` is stored
K-MAJOR — the transpose of the reference's q — as (N, K) int8 for 8 bits
and (N/2, K) for 4 bits, each byte of the latter holding logical columns
2j (low nibble) and 2j+1 (high nibble) at one k, packed exactly as
`pack4` packs the reference's (K, N/2). The tensor-core int8 product takes
its B operand with 4 consecutive k per register, so the kernels read
K-major rows directly; the transpose is made once, at quantize or
`params_from_jax` time, and no other copy of the weights is kept. `s`
keeps the reference's (1, N).

The kernel gate is the reference's (`_qm8a8`/`_qm4`): a 2-D weight with
`x.shape[-1] % 128 == 0` and a packed row count (the reference's
`q.shape[-1]`) `% 128 == 0` goes to K5/K6; any other shape computes
W8A16 / W4A16, as the TPU does there — on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from dynamo_tpu_torch.engine import int4_mm

# layer keys that get quantized (contraction dim = axis -2 of the logical
# weight)
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANTIZE_MODES = ("int8", "w8a8", "int4")


class QTensor(nn.Module):
    """Weight stored as int8 (K-major) + per-output-channel fp32 scale.

    bits=8: q is (N, K) int8, the transpose of the logical (K, N) weight.
    bits=4: q is (N/2, K) int8, two 4-bit values per byte (`pack4`).
    s: (1, N) fp32 — broadcasts onto the matmul output `(x @ q) * s`.
    act_bits: 16 = W8A16 / W4A16 product; 8 = W8A8 (K5). int4 always runs
    its A8 kernel inside the gate, so act_bits stays 16 there (asserted by
    `quantize`)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bits: int = 8,
                 act_bits: int = 16) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.bits = bits
        self.act_bits = act_bits

    @property
    def shape(self) -> tuple:
        """LOGICAL weight shape (K, N); int4 reports the unpacked width."""
        rows, k = self.q.shape
        return (k, rows * 2 if self.bits == 4 else rows)

    @property
    def nbytes(self) -> int:
        """Physical bytes (int4 = N/2 per k)."""
        return self.q.nbytes + self.s.nbytes

    def extra_repr(self) -> str:
        return (f"shape={self.shape}, bits={self.bits}, "
                f"act_bits={self.act_bits}")


def pack4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] → nibble-packed int8, pairs along the last
    axis (even logical index = low nibble). The low nibble stores `lo + 8`
    (unsigned), the high nibble `hi` two's-complement — the reference's
    layout bit for bit."""
    assert q.shape[-1] % 2 == 0, q.shape
    lo = torch.bitwise_and(q[..., 0::2] + 8, 0xF)
    hi = torch.bitwise_left_shift(q[..., 1::2], 4)
    return torch.bitwise_or(lo, hi).to(torch.int8)


def _unpack4(p: torch.Tensor) -> torch.Tensor:
    """Nibble-packed int8 (..., Np) → int8 values (..., 2·Np): the low
    nibble minus 8, the high nibble by an arithmetic shift."""
    lo = torch.bitwise_and(p, 0xF).to(torch.int8) - 8
    hi = torch.bitwise_right_shift(p, 4)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def quantize(w: torch.Tensor, bits: int = 8, act_bits: int = 16) -> QTensor:
    """Per-output-channel symmetric quantization of a logical (K, N)
    weight over K, as the reference's `quantize`, stored K-major."""
    assert bits in (8, 4), bits
    assert bits == 8 or act_bits == 16, (bits, act_bits)
    assert w.ndim == 2, w.shape
    wf = w.float()
    qmax = (1 << (bits - 1)) - 1
    s = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) \
        * int4_mm.recip32(qmax)
    q = torch.clamp(torch.round(wf / s), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = pack4(q)
    return QTensor(q.T.contiguous(), s, bits=bits, act_bits=act_bits)


def _kernel_gate(x: torch.Tensor, w: QTensor) -> bool:
    """The reference's gate (its weights are 2-D there, as every QTensor
    is here): q.shape[0] here is its q.shape[-1]."""
    return x.shape[-1] % 128 == 0 and w.q.shape[0] % 128 == 0


def _w16(x: torch.Tensor, q_kn: torch.Tensor, s: torch.Tensor
         ) -> torch.Tensor:
    """W8A16 / W4A16: `(x @ q) * s` in the activation dtype; q_kn is the
    logical (K, N) int8 (a transposed view of the K-major storage)."""
    return (x @ q_kn.to(x.dtype)) * s.to(x.dtype)


def _flat(fn, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    lead = x.shape[:-1]
    y = fn(x.reshape(-1, x.shape[-1]).contiguous(), w.q, w.s)
    return y.reshape(*lead, y.shape[-1])


def qm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Matmul against a maybe-quantized weight: `x @ w`. A plain tensor
    takes exactly `x @ w`."""
    if isinstance(w, QTensor):
        if w.bits == 4:
            return _qm4(x, w)
        if w.act_bits == 8:
            return _qm8a8(x, w)
        return _w16(x, w.q.T, w.s)
    return x @ w


def _qm8a8(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """W8A8 through K5 inside the gate, W8A16 outside it."""
    if _kernel_gate(x, w):
        return _flat(int4_mm.w8a8_matmul, x, w)
    return _w16(x, w.q.T, w.s)


def _qm4(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """W4A8 through K6 inside the gate, W4A16 outside it."""
    if _kernel_gate(x, w):
        return _flat(int4_mm.int4_matmul, x, w)
    return _w16(x, _unpack4(w.q.T), w.s)


def _a8_kind(w: Any) -> str | None:
    """"w8a8" / "int4" for a weight K5 / K6 would take, else None."""
    if not isinstance(w, QTensor):
        return None
    if w.bits == 4:
        return "int4"
    return "w8a8" if w.act_bits == 8 else None


def qm_group(x: torch.Tensor, ws: list) -> list[torch.Tensor]:
    """`[qm(x, w) for w in ws]` for projections that read the same
    activations (q/k/v, gate/up). Where every weight is an A8 QTensor of
    one kind inside the kernel gate, one K5 / K6 call multiplies them all
    (one row quantize, one GEMM, one counted launch), bit-identical to the
    separate calls; anything else takes `qm` per weight."""
    kind = _a8_kind(ws[0])
    if len(ws) > 1 and len(ws) <= int4_mm.MAX_GROUP and kind is not None \
            and all(_a8_kind(w) == kind and _kernel_gate(x, w) for w in ws):
        fn = (int4_mm.int4_matmul_group if kind == "int4"
              else int4_mm.w8a8_matmul_group)
        lead = x.shape[:-1]
        ys = fn(x.reshape(-1, x.shape[-1]).contiguous(),
                [(w.q, w.s) for w in ws])
        return [y.reshape(*lead, y.shape[-1]) for y in ys]
    return [qm(x, w) for w in ws]


# The reference keeps a vocab this wide in bf16 (its int8 lm_head sent the
# TPU compile into a tailspin); the port keeps the rule so both packages
# serve the same function.
LM_HEAD_QUANT_MAX_VOCAB = 65536


def _lm_head_quant_ok(w) -> bool:
    return w.shape[-1] <= LM_HEAD_QUANT_MAX_VOCAB


def _bits_of(mode) -> int:
    return 4 if mode in (4, "int4") else 8


def _act_bits_of(mode) -> int:
    return 8 if mode == "w8a8" else 16


def set_weight(owner: nn.Module, name: str, value) -> None:
    """Replace `owner.<name>` (a Parameter or a QTensor) by `value`."""
    delattr(owner, name)
    setattr(owner, name, value)


def _shared_copy(model: nn.Module) -> nn.Module:
    """A new model of the same class whose every tensor IS the given
    model's (nothing is copied; built on the meta device first, so no
    memory is allocated for it)."""
    out = type(model)(model.cfg, torch.device("meta"))
    for owner_out, owner in [(out, model)] + list(zip(out.layers,
                                                      model.layers)):
        for name in [n for n, _ in owner_out.named_parameters(recurse=False)]:
            set_weight(owner_out, name, getattr(owner, name))
    return out


def is_quantized(model: nn.Module) -> bool:
    return isinstance(model.lm_head, QTensor) or any(
        isinstance(getattr(layer, k), QTensor)
        for layer in model.layers for k in QUANT_KEYS)


@torch.inference_mode()
def quantize_params(model: nn.Module, mode: str = "int8",
                    inplace: bool = False) -> nn.Module:
    """Quantize a `LlamaModel`'s projections (and its lm_head, under the
    vocab rule) for `mode`. Idempotent: QTensors pass through. In place
    only when asked (each bf16 weight is freed as its QTensor replaces
    it); otherwise the result shares every other tensor with `model`,
    which is left as it was."""
    bits, act_bits = _bits_of(mode), _act_bits_of(mode)
    out = model if inplace else _shared_copy(model)
    for layer in out.layers:
        for key in QUANT_KEYS:
            w = getattr(layer, key)
            if not isinstance(w, QTensor):
                set_weight(layer, key, quantize(w, bits, act_bits))
    if not isinstance(out.lm_head, QTensor) \
            and _lm_head_quant_ok(out.lm_head):
        # lm_head stays int8 even under int4: its rounding error lands
        # directly on the logits
        set_weight(out, "lm_head", quantize(out.lm_head, 8))
    return out


def remark_act_bits(model: nn.Module, inplace: bool = False) -> nn.Module:
    """Mark a pre-quantized model's 8-bit layer weights W8A8 (the
    reference's `remark_act_bits`): new QTensors over the same q and s, no
    device work. The lm_head stays A16."""
    out = model if inplace else _shared_copy(model)
    for layer in out.layers:
        for key in QUANT_KEYS:
            w = getattr(layer, key)
            if isinstance(w, QTensor) and w.bits == 8:
                set_weight(layer, key, QTensor(w.q, w.s, bits=8, act_bits=8))
    return out


def weight_bytes(model: nn.Module) -> int:
    """Resident bytes of every tensor the model holds (parameters and the
    QTensors' buffers)."""
    return sum(t.nbytes for t in model.parameters()) + \
        sum(t.nbytes for t in model.buffers())
