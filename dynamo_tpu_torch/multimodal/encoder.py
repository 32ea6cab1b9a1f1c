"""Image → discrete-token encoder (the encode worker's compute), in PyTorch.

Port of `dynamo_tpu/multimodal/encoder.py`: `ImageEncoderConfig`,
`load_trained_encoder` (`:42`), `init_encoder_params` (`:122`),
`encode_image_tokens` (`:135`) and `load_image` (`:152`). A ViT-style
patchify + projection followed by vector quantization against a
codebook: two matmuls and an argmin in fp32, on the card (or the CPU
when the tensors are there). `torch.argmin` returns the first minimum,
as `jnp.argmin` does, so a tie goes to the lower code.

`load_image` needs no imaging library (the card's machine has none): a
PNG decoder on the standard library's `zlib` (8-bit RGB and RGBA, not
interlaced, the five row filters; alpha is dropped as Pillow's
`convert("RGB")` drops it) and a numpy copy of Pillow's default
`Image.resize` (bicubic, in Pillow's fixed-point arithmetic: 22-bit
coefficients, a horizontal pass to 8 bits, then a vertical one; an image
already at the size is returned as it is). Both are held against Pillow
bit for bit by the tests. Any other file answers `ValueError`, which the
encode worker reports as a bad image, as the reference reports a file
Pillow cannot open.

The trained weights are a build artifact (`*.npz` is not committed):
`load_trained_encoder` trains them at first use on the CPU
(`multimodal/train_encoder.py`) and keeps them in `encoder_weights.npz`
beside this module. The port's weights are not the JAX package's bit for
bit (the reference says as much of its own backends); to compare the
two packages, carry one set of weights across.
"""

from __future__ import annotations

import base64
import dataclasses
import glob
import hashlib
import logging
import math
import os
import struct
import zlib

import numpy as np
import torch

logger = logging.getLogger(__name__)

WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "encoder_weights.npz")


@dataclasses.dataclass(frozen=True)
class ImageEncoderConfig:
    image_size: int = 224
    patch_size: int = 16
    embed_dim: int = 256
    codebook_size: int = 1024
    # image tokens are emitted as vocab_offset + code, so the LM treats
    # them as ordinary (reserved-range) token ids
    vocab_offset: int = 0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


def _sweep_stale_temps(path: str) -> None:
    """Remove the temporary files of trainings whose process died (a live
    concurrent trainer's file is left alone)."""
    for stale in glob.glob(f"{glob.escape(path)}.*.tmp.npz"):
        try:
            owner = int(stale.rsplit(".", 3)[-3])
            os.kill(owner, 0)             # raises if no such process
        except (ValueError, IndexError, ProcessLookupError):
            try:
                os.remove(stale)
            except OSError:
                pass
        except OSError:
            pass                          # alive but not ours (EPERM)


def load_trained_encoder(cfg: ImageEncoderConfig,
                         device: "str | torch.device" = "cpu"
                         ) -> dict | None:
    """The trained VQ weights {"proj", "codebook"} as fp32 tensors on
    `device`, or None when they are unavailable or do not match `cfg`.
    A missing file is trained first (seed 0, on the CPU, written under a
    temporary name and renamed into place, so concurrent workers race
    safely) unless DYN_TRAIN_ENCODER=0."""
    path = WEIGHTS_FILE
    if not os.path.exists(path) \
            and os.environ.get("DYN_TRAIN_ENCODER", "1") != "0":
        try:
            logger.warning("training the VQ image encoder (first use, on "
                           "the CPU; kept at %s)", path)
            from dynamo_tpu_torch.multimodal.train_encoder import train

            params, l_rec = train()
            _sweep_stale_temps(path)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, **params,
                                meta_recon_loss=np.float32(l_rec))
            os.replace(tmp, path)
        except Exception:
            logger.exception("encoder training failed; using random init")
            return None
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            proj = z["proj"]
            codebook = z["codebook"]
    except (KeyError, OSError, ValueError):
        return None
    if proj.shape != (cfg.patch_dim, cfg.embed_dim) or \
            codebook.shape != (cfg.codebook_size, cfg.embed_dim):
        return None
    # image-token ids are stable across a deployment only when every
    # worker holds the same weights: compare this hash across workers
    logger.info("VQ encoder codebook hash: %s", hashlib.blake2s(
        codebook.tobytes(), digest_size=8).hexdigest())
    dev = torch.device(device)
    return {"proj": torch.from_numpy(np.ascontiguousarray(proj)).to(dev),
            "codebook": torch.from_numpy(
                np.ascontiguousarray(codebook)).to(dev)}


def init_encoder_params(gen: torch.Generator, cfg: ImageEncoderConfig,
                        device: "str | torch.device" = "cpu") -> dict:
    """Random weights from `gen` (a seeded `torch.Generator` on
    `device`): proj N(0, 1/patch_dim), codebook N(0, 1), fp32."""
    dev = torch.device(device)
    proj = torch.randn((cfg.patch_dim, cfg.embed_dim), generator=gen,
                       device=dev) * (1.0 / math.sqrt(cfg.patch_dim))
    codebook = torch.randn((cfg.codebook_size, cfg.embed_dim),
                           generator=gen, device=dev)
    return {"proj": proj, "codebook": codebook}


@torch.inference_mode()
def encode_image_tokens(params: dict, image: torch.Tensor,
                        cfg: ImageEncoderConfig) -> torch.Tensor:
    """image (S, S, 3) float32 in [0, 1] → (num_patches,) int32 tokens, on
    the image's device: each patch (row-major over (p, p, 3), minus its
    own mean) projected, then its nearest codebook entry by L2, in the
    matmul form ||c||² - 2 e·c (no (N, C, E) broadcast), plus the offset."""
    s, p = cfg.image_size, cfg.patch_size
    n = s // p
    patches = image.float().reshape(n, p, n, p, 3).permute(0, 2, 1, 3, 4)
    patches = patches.reshape(cfg.num_patches, cfg.patch_dim)
    patches = patches - patches.mean(dim=-1, keepdim=True)
    emb = patches @ params["proj"]                             # (N, E)
    dots = emb @ params["codebook"].T                          # (N, C)
    c2 = (params["codebook"] ** 2).sum(dim=-1)                 # (C,)
    codes = torch.argmin(c2[None, :] - 2.0 * dots, dim=-1)
    return (codes + cfg.vocab_offset).to(torch.int32)


# -- image decoding ----------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {2: 3, 6: 4}             # color type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: (height, stride) uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        ftype, data = row[0], np.frombuffer(row[1:], dtype=np.uint8)
        if ftype == 0:                            # None
            cur = data.copy()
        elif ftype == 1:                          # Sub: a running sum per
            cur = data.copy()                     # sample, mod 256
            for i in range(bpp):
                cur[i::bpp] = np.cumsum(data[i::bpp], dtype=np.uint8)
        elif ftype == 2:                          # Up
            cur = data + prev
        elif ftype in (3, 4):                     # Average, Paeth
            cur = bytearray(stride)
            up = prev.tolist()
            for i, x in enumerate(data.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (x + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), dtype=np.uint8)
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG, not interlaced → (H, W, 3) uint8 (alpha
    dropped). Anything else raises ValueError."""
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG image (only PNG is decoded)")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG chunk is truncated")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG has no IHDR or no image data")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace}: only 8-bit RGB and RGBA, "
                         f"not interlaced, are decoded")
    if not width or not height:
        raise ValueError("PNG has no pixels")
    bpp = _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    pixels = _unfilter(raw, height, width * bpp, bpp)
    return pixels.reshape(height, width, bpp)[..., :3]


# Pillow's Resample.c: coefficients carry 22 fractional bits
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic convolution kernel (a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` over the
    whole source: (out, ksize) source indices and int64 coefficients
    (zero past each window's end)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), dtype=np.int64)
    kk = np.zeros((out_size, ksize), dtype=np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5)
                     * (1.0 / filterscale))
        ww = 0.0
        for v in w.tolist():               # C's sequential double sum
            ww += v
        if ww != 0.0:
            w = w / ww
        # (int)(±0.5 + w · 2^22): C truncates toward zero
        kk[xx, :xmax] = np.trunc(np.where(w < 0, -0.5, 0.5)
                                 + w * (1 << _PRECISION_BITS))
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
        idx[xx, xmax:] = xmin
    return idx, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` (1: horizontal, 0: vertical): rounded
    fixed-point sums, clipped to 0..255."""
    idx, kk = _coeffs(img.shape[axis], out_size)
    src = np.take(img, idx, axis=axis).astype(np.int64)  # axis -> (out, k)
    shape = [1] * src.ndim
    shape[axis], shape[axis + 1] = kk.shape
    acc = (src * kk.reshape(shape)).sum(axis=axis + 1) \
        + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: int) -> np.ndarray:
    """Pillow's `Image.resize((size, size))` of an (H, W, 3) uint8 RGB
    image (its default bicubic filter): the horizontal pass, then the
    vertical one, each skipped when that side already has the size."""
    h, w, _ = img.shape
    if w != size:
        img = _resample_axis(img, size, axis=1)
    if h != size:
        img = _resample_axis(img, size, axis=0)
    return img


def load_image(data: "bytes | str", cfg: ImageEncoderConfig) -> np.ndarray:
    """PNG bytes (or a base64 / data-URL string) → (S, S, 3) f32 in
    [0, 1]."""
    if isinstance(data, str):
        if data.startswith("data:"):
            data = data.split(",", 1)[1]
        data = base64.b64decode(data)
    img = resize(decode_png(data), cfg.image_size)
    return np.asarray(img, dtype=np.float32) / 255.0
