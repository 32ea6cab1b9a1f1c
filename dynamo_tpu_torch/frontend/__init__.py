"""Frontend component: OpenAI HTTP server + model discovery.

`python -m dynamo_tpu_torch.frontend` — the port of `python -m
dynamo_tpu.frontend`.
"""
