"""Train the image VQ encoder (straight-through VQ-VAE) on the CPU.

Port of `dynamo_tpu/multimodal/train_encoder.py`: the serving pipeline
needs an encoder whose codes are content-meaningful (similar patches map
to the same code, distinct textures to distinct codes), so repeated or
related images hit the KV prefix cache. No pretrained vision weights are
at hand, so the encoder is trained here, reproducibly, on the reference's
synthetic corpus of structured images (gradients, checkers, stripes,
disks, smooth per-channel noise), made by the same numpy generator.

Objective, as the reference's (VQ-VAE, Oord et al.):
    z  = (x - mean(x)) @ proj
    q  = codebook[argmin ||z - c||]
    x̂ = q @ dec
    L  = ||x̂ - x||² + ||sg[z] - q||² + β||z - sg[q]||²
with straight-through gradients through the quantizer and dead-code
re-seeding (codes unused for a full pass jump to a random batch vector).
The optimizer is `torch.optim.Adam` with optax's defaults (eps 1e-8
added outside the square root, as both define it). The initial weights
come from a seeded `torch.Generator`, so the result is deterministic but
not the JAX package's weights bit for bit.

`python -m dynamo_tpu_torch.multimodal.train_encoder` writes
`encoder_weights.npz` beside `encoder.py` (seed 0; about a minute on a
few CPU cores).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.multimodal.encoder import (
    WEIGHTS_FILE,
    ImageEncoderConfig,
)


def synth_images(rng: np.random.Generator, n: int, size: int
                 ) -> np.ndarray:
    """(n, size, size, 3) f32 in [0,1]: structured synthetic images (the
    reference's corpus, draw for draw)."""
    out = np.zeros((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        kind = i % 5
        c0, c1 = rng.random(3), rng.random(3)
        if kind == 0:                      # linear gradient, random angle
            a = rng.random() * 2 * np.pi
            t = (np.cos(a) * xx + np.sin(a) * yy)
            t = (t - t.min()) / (np.ptp(t) + 1e-6)
            img = t[..., None] * c0 + (1 - t[..., None]) * c1
        elif kind == 1:                    # checkerboard, random period
            p = int(rng.integers(4, 33))
            m = (((np.arange(size) // p)[:, None]
                  + (np.arange(size) // p)[None, :]) % 2).astype(np.float32)
            img = m[..., None] * c0 + (1 - m[..., None]) * c1
        elif kind == 2:                    # stripes
            p = rng.integers(3, 24)
            m = (np.sin(2 * np.pi * xx * p) > 0).astype(np.float32)
            img = m[..., None] * c0 + (1 - m[..., None]) * c1
        elif kind == 3:                    # disks on a background
            img = np.broadcast_to(c1, (size, size, 3)).copy()
            for _ in range(int(rng.integers(1, 6))):
                cy, cx = rng.random(2)
                r = 0.05 + 0.2 * rng.random()
                mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
                img[mask] = rng.random(3)
        else:                              # smooth per-channel noise
            low = rng.random((8, 8, 3)).astype(np.float32)
            reps = size // 8
            img = np.kron(low, np.ones((reps, reps, 1), np.float32))
        out[i] = np.clip(img, 0.0, 1.0)
    return out


def _codes(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nearest code per row, the rows' embeddings z)."""
    z = x @ params["proj"]
    d = (params["codebook"] ** 2).sum(dim=-1)[None, :] \
        - 2.0 * z @ params["codebook"].T
    return torch.argmin(d, dim=-1), z


def train(seed: int = 0, n_images: int = 160, steps: int = 600,
          lr: float = 3e-3, beta: float = 0.25, verbose: bool = False):
    """Returns (params {"proj", "codebook", "dec"} as numpy fp32, final
    reconstruction loss). Runs on the CPU."""
    cfg = ImageEncoderConfig()
    rng = np.random.default_rng(seed)
    imgs = synth_images(rng, n_images, cfg.image_size)
    p, s = cfg.patch_size, cfg.image_size
    n = s // p
    patches = imgs.reshape(n_images, n, p, n, p, 3) \
        .transpose(0, 1, 3, 2, 4, 5).reshape(-1, cfg.patch_dim)
    patches = torch.from_numpy(
        patches - patches.mean(axis=-1, keepdims=True))

    gen = torch.Generator().manual_seed(seed)
    params = {
        "proj": torch.randn((cfg.patch_dim, cfg.embed_dim), generator=gen)
        * (1.0 / math.sqrt(cfg.patch_dim)),
        "codebook": torch.randn((cfg.codebook_size, cfg.embed_dim),
                                generator=gen) * 0.1,
        "dec": torch.randn((cfg.embed_dim, cfg.patch_dim), generator=gen)
        * 0.05,
    }
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    bs = 4096
    nb = patches.shape[0] // bs
    used = np.zeros(cfg.codebook_size, bool)
    l_rec = None
    for it in range(steps):
        x = patches[(it % nb) * bs:(it % nb + 1) * bs]
        idx, z = _codes(params, x)
        # the codebook rows as a one-hot product: the same values as a
        # gather, and a backward that sums in a fixed order (the gather's
        # scatter-add backward is not deterministic across CPU threads)
        q = F.one_hot(idx, cfg.codebook_size).to(z.dtype) @ params["codebook"]
        st = z + (q - z).detach()                 # straight-through
        recon = st @ params["dec"]
        l_rec = torch.mean((recon - x) ** 2)
        l_cb = torch.mean((z.detach() - q) ** 2)
        l_commit = torch.mean((z - q.detach()) ** 2)
        opt.zero_grad(set_to_none=True)
        (l_rec + l_cb + beta * l_commit).backward()
        opt.step()
        used[idx.numpy()] = True
        if (it + 1) % nb == 0:
            # dead-code re-seed: unused codes jump onto random batch
            # embeddings (after this step's update) so the whole book
            # takes part
            dead = np.flatnonzero(~used)
            if dead.size:
                with torch.no_grad():
                    zs = x @ params["proj"]
                    pick = rng.integers(0, zs.shape[0], dead.size)
                    params["codebook"][torch.from_numpy(dead)] = \
                        zs[torch.from_numpy(pick)]
            used[:] = False
        if verbose and it % 100 == 0:
            print(f"step {it}: recon {float(l_rec.detach()):.5f}")
    return ({k: v.detach().numpy().copy() for k, v in params.items()},
            float(l_rec.detach()))


def main() -> None:
    params, l_rec = train(verbose=True)
    np.savez_compressed(WEIGHTS_FILE, **params,
                        meta_recon_loss=np.float32(l_rec))
    size = os.path.getsize(WEIGHTS_FILE)
    print(f"saved {WEIGHTS_FILE} ({size / 2**20:.2f} MiB, "
          f"recon {l_rec:.5f})")


if __name__ == "__main__":
    main()
