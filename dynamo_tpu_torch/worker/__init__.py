"""Engine worker component.

`python -m dynamo_tpu_torch.worker` — the port of `python -m
dynamo_tpu.worker`: boots a TorchEngine (or the echo engine), serves its
`generate` endpoint and publishes its model card.
"""
