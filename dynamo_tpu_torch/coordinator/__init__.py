"""Coordinator service: the control-plane store server.

`python -m dynamo_tpu_torch.coordinator --port 6379` runs the TCP lease-KV
coordinator every other component points its `--store tcp://host:port`
at — the port of `python -m dynamo_tpu.coordinator`.
"""
