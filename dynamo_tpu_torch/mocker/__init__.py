"""Mock engine: a simulation of the serving engine that needs no device.

Port of `dynamo_tpu/mocker/` (the port keeps its own copy): a paged KV
cache with prefix reuse, watermark admission, preemption, and prefill /
decode timing, publishing real KV events and ForwardPassMetrics, so the
router, the frontend and the fault paths run against fleets of any size
with no card. It creates no CUDA context and allocates nothing on a
card: a fleet of mock workers on a card's machine leaves the card alone.

Reference: `lib/llm/src/mocker/` (MockVllmEngine, `mocker/engine.rs:48`).
"""

from dynamo_tpu_torch.mocker.kv_manager import MockKvManager
from dynamo_tpu_torch.mocker.engine import MockEngine, MockEngineConfig

__all__ = ["MockEngine", "MockEngineConfig", "MockKvManager"]
