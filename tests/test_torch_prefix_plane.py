"""The port's prefix-heat plane (`dynamo_tpu_torch/router/prefix_plane.py`,
armed by `DYN_PREFIX_HEAT`) held to the JAX package's.

- The JAX package's own cases that need no doctor, perf ledger or aiohttp
  (`tests/test_prefix_plane.py`), as written and on the port
  (`port_copy`): the plane off by default; armed routing byte-identical
  to unarmed with the live selector's RNG untouched while the shadow
  diverges; the hand-traced counterfactual; a tie is agreement; tier
  runs extend device prefixes; the pull-cost gate; the duplication
  maths; depths from the radix tree; the payload's shape; the unarmed
  /metrics surface; the telemetry plane's prefix block.
- Both packages' KV routers, armed, fed the same seeded KV events, tier
  residency, metrics and requests with their selectors seeded alike: the
  same placements, and `/debug/prefixes` bodies (`prefix_payload`) and
  telemetry prefix blocks that are equal, once each record's wall-clock
  `at` is dropped.
"""

import json
import random

import pytest

from dynamo_tpu import protocols as rp
from dynamo_tpu.router import kv_router as rk
from dynamo_tpu.router import prefix_plane as rpp
from dynamo_tpu.runtime import metrics as r_metrics
from dynamo_tpu.runtime import telemetry as r_tel
from dynamo_tpu_torch import protocols as tp
from dynamo_tpu_torch.router import kv_router as tk
from dynamo_tpu_torch.router import prefix_plane as tpp
from dynamo_tpu_torch.runtime import metrics as t_metrics
from dynamo_tpu_torch.runtime import telemetry as t_tel
from dynamo_tpu_torch.tokens import compute_block_hashes, compute_seq_hashes
from tests.test_torch_faults import port_copy, run_case

BS = 16
REF_CASES = [
    "test_recorder_off_by_default",
    "test_armed_routing_byte_identical_and_rng_untouched",
    "test_hand_traceable_counterfactual",
    "test_tie_is_agreement_not_divergence",
    "test_tier_extends_device_prefix",
    "test_pull_cost_gate_blocks_uneconomic_credit",
    "test_duplication_math",
    "test_observe_index_depths_from_radix_tree",
    "test_payload_unarmed_hint_and_armed_shape",
    "test_unarmed_metrics_surface_unchanged",
    "test_prefix_summary_telemetry",
]


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_prefix_case(case, pkg, request, monkeypatch):
    import tests.test_prefix_plane as ref_cases

    monkeypatch.delenv("DYN_PREFIX_HEAT", raising=False)
    run_case(ref_cases if pkg == "ref" else port_copy("test_prefix_plane"),
             case, request)


def _stored(mod, worker, tokens, eid):
    return mod.KvCacheEvent(
        kind=mod.KV_STORED, worker_id=worker, event_id=eid,
        blocks=[mod.StoredBlock(s, h) for s, h in zip(
            compute_seq_hashes(tokens, BS), compute_block_hashes(tokens, BS))])


def _without_at(payload: dict) -> dict:
    out = json.loads(json.dumps(payload))
    for r in out.get("records", ()):
        r.pop("at")
    return out


def _drive(kmod, pmod, pmod_proto, metrics_mod, seed: int, nbytes: int):
    """An armed router of one package through a seeded workload: four
    workers, shared and private prompt prefixes stored on some of them,
    worker 4's host tier holding deep chains, routed requests that share
    prefixes. (placements, payload, registry)."""
    rng = random.Random(seed)
    router = kmod.KvRouter(kmod.KvRouterConfig(block_size=BS))
    router.prefix_heat = pmod.PrefixHeatRecorder(block_size=BS,
                                                 block_nbytes=nbytes)
    router.selector.rng = random.Random(seed)
    reg = metrics_mod.MetricsRegistry()
    router.register_metrics(reg)
    for w in (1, 2, 3, 4):
        router.add_worker(w)
    bases = [[rng.randrange(1000) for _ in range(BS * rng.randint(2, 6))]
             for _ in range(6)]
    eids = {w: 0 for w in (1, 2, 3, 4)}
    placed = []
    for i in range(40):
        base = rng.choice(bases)
        toks = base[:BS * rng.randint(1, len(base) // BS)] + [
            rng.randrange(1000) for _ in range(rng.randint(0, 40))]
        if rng.random() < 0.5:
            w = rng.randint(1, 3)
            eids[w] += 1
            router.apply_kv_event(_stored(pmod_proto, w, toks, eids[w]))
        if rng.random() < 0.3:
            router.prefix_heat.observe_tiers((4, 0), {
                h: ("host", nbytes) for h in compute_seq_hashes(
                    rng.choice(bases), BS)})
        res = router.find_best_match(f"r{i}", toks)
        placed.append((res.worker, res.overlap_blocks, res.prefill_tokens))
    return placed, pmod.prefix_payload(router), reg


@pytest.mark.parametrize("seed,nbytes", [(0, 0), (1, 1 << 23), (2, 1 << 21)])
def test_armed_planes_match_reference(seed, nbytes):
    got = _drive(tk, tpp, tp, t_metrics, seed, nbytes)
    want = _drive(rk, rpp, rp, r_metrics, seed, nbytes)
    assert got[0] == want[0]
    assert _without_at(got[1]) == _without_at(want[1])
    assert got[1]["summary"]["decisions"] == 40
    assert got[1]["summary"]["duplication"]["blocks_tracked"] > 0
    snap = (t_tel.snapshot_metrics(got[2]), r_tel.snapshot_metrics(want[2]))
    assert t_tel.prefix_summary(snap[0]) == r_tel.prefix_summary(snap[1])
    assert t_tel.prefix_summary(snap[0]) is not None
