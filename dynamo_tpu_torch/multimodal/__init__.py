"""Multimodal serving: the encode → prefill → decode worker trio.

Port of `dynamo_tpu/multimodal/`: the encode worker vector-quantizes image
patches into DISCRETE tokens from a reserved vocabulary range, so image
content rides the same token path as text (router prefix hashing, paged
KV, disagg, migration unchanged) and only a short token list crosses
workers.
"""

from dynamo_tpu_torch.multimodal.encoder import (
    ImageEncoderConfig,
    encode_image_tokens,
    init_encoder_params,
    load_image,
)
from dynamo_tpu_torch.multimodal.worker import (
    ENCODE_ENDPOINT,
    EncodeWorkerHandler,
    serve_encode_worker,
)

__all__ = [
    "ImageEncoderConfig",
    "encode_image_tokens",
    "init_encoder_params",
    "load_image",
    "ENCODE_ENDPOINT",
    "EncodeWorkerHandler",
    "serve_encode_worker",
]
