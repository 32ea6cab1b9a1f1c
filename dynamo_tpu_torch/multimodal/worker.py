"""Encode worker: images → discrete image tokens, served over the runtime.

Port of `dynamo_tpu/multimodal/worker.py`: `EncodeWorkerHandler` and
`serve_encode_worker` on the port's runtime, with the encoder's weights
and its matmuls on the card (`device`, "cuda" by default; raises without
a card unless the caller asks for the CPU). The wire format is the
reference's, `{"image": <base64 or data URL>}` in and `{"image_tokens":
[...], "num_patches": n}` (or `{"error": ...}`) out, so each package's
frontend can use the other's encode worker. The preprocessor calls it
per image part and splices the returned tokens into the prompt; the
prefill and decode workers stay modality-blind.
"""

from __future__ import annotations

import asyncio
import logging
from typing import AsyncIterator, Optional

import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.multimodal.encoder import (
    ImageEncoderConfig,
    encode_image_tokens,
    init_encoder_params,
    load_image,
    load_trained_encoder,
)
from dynamo_tpu_torch.runtime.context import Context

logger = logging.getLogger(__name__)

ENCODE_ENDPOINT = "encode"


class EncodeWorkerHandler:
    """{"image": <b64/data-url>} → {"image_tokens": [...]}."""

    def __init__(self, cfg: Optional[ImageEncoderConfig] = None,
                 rng_seed: int = 0, device: str = "cuda",
                 params: Optional[dict] = None) -> None:
        """The trained weights by default (trained at first use when the
        file is absent); a random init from `rng_seed` only when they are
        unavailable or the geometry does not match them. `params` gives
        the weights outright (fp32 tensors, moved to `device`)."""
        self.cfg = cfg or ImageEncoderConfig()
        self.device = resolve_device(device)
        if params is None:
            params = load_trained_encoder(self.cfg, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
            params = init_encoder_params(gen, self.cfg, self.device)
        self.params = {k: v.to(self.device, torch.float32)
                       for k, v in params.items()}

    def encode(self, data) -> list[int]:
        """One image's tokens (raises ValueError on a bad image)."""
        img = torch.from_numpy(load_image(data, self.cfg)).to(self.device)
        return encode_image_tokens(self.params, img, self.cfg).tolist()

    async def generate(self, request: dict, context: Context
                       ) -> AsyncIterator[dict]:
        data = request.get("image")
        if not data:
            yield {"error": "missing 'image' (base64 or data URL)"}
            return
        try:
            tokens = await asyncio.to_thread(self.encode, data)
        except Exception as e:
            logger.warning("image decode/encode failed: %r", e)
            yield {"error": f"bad image: {e!r}"}
            return
        yield {"image_tokens": [int(t) for t in tokens],
               "num_patches": self.cfg.num_patches}


async def serve_encode_worker(runtime, namespace: str = "dynamo",
                              component: str = "encoder",
                              instance_id: Optional[int] = None,
                              cfg: Optional[ImageEncoderConfig] = None,
                              handler: Optional[EncodeWorkerHandler] = None):
    """Register the encode endpoint (a handler of `cfg` on the card unless
    `handler` is given, already built); returns the ServedEndpoint."""
    handler = handler or EncodeWorkerHandler(cfg)
    ep = (runtime.namespace(namespace).component(component)
          .endpoint(ENCODE_ENDPOINT))
    return await ep.serve(handler.generate, instance_id=instance_id)
