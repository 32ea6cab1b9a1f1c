"""One CUDA graph per (entry, shape bucket): the port's counterpart of the
reference's `jax.jit` step entries.

The reference never runs a step op by op: each device entry is a jitted
program, compiled once per shape bucket (`engine/compile_tracker.py`
records the first call of each), so a fused k-step burst is one dispatch.
Here the engine routes its fixed-shape entries ("prefill",
"mixed_step", "sample_first", "decode_burst", "decode_guided",
"ragged_step") through `StepGraphs.run`, which captures
the step into a CUDA graph the first time its key is seen and replays that
graph after.

- **Static buffers.** Each graph owns static device input buffers and the
  outputs its capture allocated. A dispatch copies the host arrays into
  the inputs (pinned memory, non-blocking, on the current stream) and
  replays; a device tensor (the pipelined burst's input tokens, the first
  token's logits) is copied on the device. The outputs are the same
  tensors at every replay: a caller must copy or consume them before the
  graph replays again (the engine copies a chunk round's and a mixed
  step's last-token logits when it keeps them: two prompts that finish
  in different rounds of one key are sampled from their own rows).
- **State a step closes over.** What is large and changes rarely is not
  an input: "decode_guided" reads the engine's resident grammar tables
  (hundreds of MB for JSON mode at a 128k vocabulary), one set of buffers
  per row bucket, the bucket being part of the key. A new grammar is
  written into them in place, between replays, on the same stream; a
  bucket that grows gets new buffers and a new graph, and the old buffers
  stay alive for the old graph.
- **One memory pool.** All of an engine's graphs share one pool
  (`torch.cuda.graph_pool_handle()`), so a graph captured later may keep
  its intermediates where an earlier graph left its output: any replay
  may overwrite any other graph's outputs. Replays are serialized by the
  engine's device lock on one stream, and the engine copies every output
  it keeps right behind its replay on that stream (a pipelined burst's
  host copy and its next input tokens, a chunk round's kept logits), so
  no later replay can clobber it.
- **No hidden fallback.** A capture that fails raises; nothing falls back
  to eager quietly. On the CPU there are no graphs: `run` calls the step.
- **The warm-up call.** Before its capture, a step runs once eagerly on
  the live inputs, on the capture stream: that loads the kernels,
  creates cuBLAS's handle and workspace for the stream, and sizes the
  kernels' persistent scratch (which refuses to grow during a capture,
  `paged_core.grow_scratch`: a "prefill" warm-up at bp 8, T 512 sizes
  K1's tickets for its 4096 rows x KV heads). Running the step twice is
  harmless only because every captured step is idempotent on its inputs:
  K2 and K3 rewrite the same cache rows with the same values (attention
  reads only rows below or at a row's own position, which the step itself
  rewrites alike — a prefill chunk rewrites its own rows, a mixed step
  its chunk rows and its burst's decode rows, as the plain burst does),
  sampling is keyed by (seed, step) on the device ("sample_first" writes
  nothing but its output), and the constrained burst advances copies of
  its output counts and DFA states, never its inputs, so the warm-up and
  the first replay give the same outputs and leave the same caches.
- **Launch counts.** A replay calls no kernel wrapper, so the graph
  records each kernel's launch delta at capture (`cuda_build.launch_delta`),
  takes it back (a capture runs nothing) and adds it at every replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.engine import cuda_build


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _copy_in(buf: torch.Tensor, a) -> None:
    """Host array or device tensor `a` into static input `buf`, queued on
    the current stream without a host sync."""
    if tuple(a.shape) != tuple(buf.shape):
        raise ValueError(f"graph input of shape {tuple(a.shape)} for a "
                         f"buffer of {tuple(buf.shape)}")
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a).pin_memory()
    buf.copy_(a, non_blocking=True)


@dataclass
class _Graph:
    graph: Any                          # torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]
    outputs: Any
    launches: dict[str, int]            # kernel launches per replay

    def load(self, inputs: Sequence) -> None:
        for buf, a in zip(self.inputs, inputs):
            _copy_in(buf, a)

    def replay(self) -> None:
        self.graph.replay()
        cuda_build.add_launches(self.launches)


class StepGraphs:
    """An engine's CUDA graphs, one per key, captured at first use."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.graphs: dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def run(self, key: tuple, fn: Callable, inputs: Sequence) -> Any:
        """`fn(*inputs)` as device tensors. CUDA: replay `key`'s graph
        with `inputs` copied into its static buffers, capturing it first
        if `key` is new; returns the graph's static outputs. CPU: the
        eager call."""
        if self.device.type != "cuda":
            return fn(*map(_tensor, inputs))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(fn, inputs)
        else:
            g.load(inputs)
        g.replay()
        self.replays += 1
        return g.outputs

    def _capture(self, fn: Callable, inputs: Sequence) -> _Graph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        static = [torch.empty(tuple(a.shape), dtype=_tensor(a).dtype,
                              device=self.device) for a in inputs]
        for buf, a in zip(static, inputs):
            _copy_in(buf, a)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            fn(*static)                                 # the warm-up
        cur.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        before = cuda_build.launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode="thread_local"):
                outputs = fn(*static)
        finally:
            launches = cuda_build.launch_delta(before,
                                               cuda_build.launch_counts())
            cuda_build.add_launches(launches, -1)      # it ran nothing
        self.captures += 1
        return _Graph(graph, static, outputs, launches)

    def pool_bytes(self) -> int:
        """Bytes the card holds for the graphs' shared pool (the segments
        of `torch.cuda.memory_snapshot()` that belong to it)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)
