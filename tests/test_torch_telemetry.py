"""The port's fleet telemetry plane (`dynamo_tpu_torch/runtime/telemetry.py`)
held against the JAX package's (`dynamo_tpu/runtime/telemetry.py`).

- The same seeded series in a port registry and a reference registry —
  every family a summary reads: engine and HTTP latency histograms,
  goodput, router, KV lifecycle, memory, mesh, prefix-plane, tenant,
  serving-class and rejection series — give equal `snapshot_metrics`,
  `merge_snapshots`, `flatten`, every `*_summary`, and `fleet_status` of
  two collectors that ingested the same payloads (clocks pinned). With a
  family absent, its summary is None in both.
- The engine's histograms have the reference's bucket edges, so a fleet
  that mixes the packages merges: a port worker and a JAX-package worker
  publish over one coordinator, and each package's frontend collector
  shows both components and the merged fleet view.
- `/fleet/status` on a port frontend answers 503 with the reference's
  body when no collector runs.
"""

import asyncio
import json

import numpy as np
import pytest

from dynamo_tpu.engine.metrics import EngineMetrics as RefEngineMetrics
from dynamo_tpu.runtime import metrics as ref_metrics
from dynamo_tpu.runtime import telemetry as ref_tel
from dynamo_tpu_torch.engine.metrics import EngineMetrics
from dynamo_tpu_torch.runtime import metrics as t_metrics
from dynamo_tpu_torch.runtime import telemetry as t_tel

PKGS = {"ref": (ref_tel, ref_metrics), "torch": (t_tel, t_metrics)}
SUMMARIES = ("latency_summary", "goodput_summary", "router_summary",
             "kv_summary", "memory_summary", "mesh_summary",
             "prefix_summary", "tenant_summary", "class_summary",
             "rejection_summary")

_STAGE = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
          0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
_ITL = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0, 1000.0,
        2000.0, 5000.0)
HISTS = {"engine_ttft_seconds": (_STAGE, 0.05),
         "engine_itl_ms": (_ITL, 20.0),
         "http_time_to_first_token_seconds": (
             (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
              30.0), 0.08),
         "router_overlap_ratio": ((0.1, 0.25, 0.5, 0.75, 0.9, 1.0), 0.4),
         "router_load_prediction_error": ((1, 4, 16, 64), 5.0),
         "kv_lifecycle_reuse_distance": ((1, 10, 100, 1000), 40.0),
         "mesh_skew_ratio": ((1.01, 1.1, 1.5, 2.0), 1.2)}
COUNTERS = {
    "engine_goodput_tokens_total": ("entry", ("prefill", "decode_burst")),
    "engine_padded_tokens_total": ("entry", ("prefill", "decode_burst")),
    "router_decisions_total": ("mode", ("route",)),
    "router_prefill_tokens_saved_total": (None, ()),
    "router_events_dropped_total": (None, ()),
    "kv_lifecycle_events_total": ("ev", ("allocate", "evict", "reuse")),
    "kv_lifecycle_tokens_saved_total": (None, ()),
    "kv_lifecycle_evictions_total": ("cause", ("lru", "clear")),
    "kv_lifecycle_premature_evictions_total": (None, ()),
    "collective_bytes_total": ("entry", ("decode", "prefill")),
    "mesh_reshard_total": ("entry", ("decode",)),
    "kv_pull_bytes_total": ("link", ("ici", "dcn")),
    "prefix_shadow_tokens_saved_total": (None, ()),
    "prefix_tier_blind_total": (None, ()),
    "prefix_shadow_divergence_total": (None, ()),
    "tenant_admitted_total": ("tenant", ("a", "b")),
    "tenant_goodput_tokens_total": ("tenant", ("a", "b")),
    "tenant_rejected_total": ("tenant", ("b",)),
    "tenant_ttft_seconds_total": ("tenant", ("a", "b")),
    "tenant_first_tokens_total": ("tenant", ("a", "b")),
    "tenant_queue_wait_seconds_total": ("tenant", ("a",)),
    "tenant_admissions_total": ("tenant", ("a",)),
    "class_admitted_total": ("class", ("interactive", "batch")),
    "class_shed_total": ("class", ("batch",)),
    "class_downgraded_total": ("class", ("interactive",)),
    "class_deadline_rejected_total": ("class", ("batch",)),
    "http_rejections_total": ("reason", ("quota", "shed")),
}
GAUGES = {
    "kvbm_tier_blocks": ("tier", ("g1", "g2")),
    "memory_class_bytes": ("class", ("weights", "kv_pool")),
    "memory_device_bytes": ("kind", ("in_use", "limit")),
    "memory_unattributed_bytes": (None, ()),
    "memory_headroom_bytes": (None, ()),
    "mesh_device_bytes": ("device", ("0", "1")),
    "prefix_duplicate_bytes": ("depth_bucket", ("1-4", "5-16")),
    "tenant_streams": ("tenant", ("a",)),
}


def populate(metrics_mod, seed: int, drop: tuple = ()):
    """A registry with every family above (less `drop`), its values drawn
    from `seed`."""
    rng = np.random.default_rng(seed)
    reg = metrics_mod.MetricsRegistry("dynamo")
    for name, (edges, scale) in HISTS.items():
        if name in drop:
            continue
        h = reg.histogram(name, buckets=edges)
        for v in rng.exponential(scale, int(rng.integers(3, 40))):
            h.observe(float(v))
    for name, (label, values) in COUNTERS.items():
        if name in drop:
            continue
        c = reg.counter(name)
        for v in values or (None,):
            labels = {label: v} if label else {}
            if name == "http_rejections_total":
                labels["class"] = "batch"
            c.inc(float(rng.integers(1, 500)), **labels)
    for name, (label, values) in GAUGES.items():
        if name in drop:
            continue
        g = reg.gauge(name)
        for v in values or (None,):
            g.set(float(rng.integers(1, 1 << 30)),
                  **({label: v} if label else {}))
    return reg


FAMILY_SETS = {
    "everything": (),
    "no_engine_latency": ("engine_ttft_seconds", "engine_itl_ms"),
    "no_router": ("router_decisions_total",),
    "no_kv_or_memory": ("kv_lifecycle_events_total", "memory_class_bytes"),
    "no_tenancy_or_classes": tuple(
        n for n in COUNTERS if n.startswith(("tenant_", "class_"))),
}


@pytest.mark.parametrize("families", sorted(FAMILY_SETS))
def test_snapshots_merges_and_summaries_match_reference(families):
    drop = FAMILY_SETS[families]
    snaps = {}
    for pkg, (tel, metrics) in PKGS.items():
        snaps[pkg] = [tel.snapshot_metrics(populate(metrics, s, drop))
                      for s in (0, 1, 2)]
    assert snaps["torch"] == snaps["ref"]
    merged = {pkg: PKGS[pkg][0].merge_snapshots(snaps[pkg]) for pkg in PKGS}
    assert merged["torch"] == merged["ref"]
    assert PKGS["torch"][0].flatten(merged["torch"]) == \
        PKGS["ref"][0].flatten(merged["ref"])
    for snap in snaps["torch"] + [merged["torch"]]:
        for fn in SUMMARIES:
            got = getattr(t_tel, fn)(snap)
            assert got == getattr(ref_tel, fn)(snap), fn
    if families == "no_router":
        assert t_tel.router_summary(merged["torch"]) is None
    if families == "everything":
        assert all(getattr(t_tel, fn)(merged["torch"]) is not None
                   for fn in SUMMARIES)


def test_merge_skips_mismatched_edges_alike():
    snaps = []
    for edges in ((0.1, 1.0), (0.1, 2.0)):
        reg = t_metrics.MetricsRegistry("dynamo")
        reg.histogram("engine_ttft_seconds", buckets=edges).observe(0.5)
        snaps.append(t_tel.snapshot_metrics(reg))
    assert t_tel.merge_snapshots(snaps) == ref_tel.merge_snapshots(snaps)
    assert t_tel.merge_snapshots(snaps)["dynamo_engine_ttft_seconds"][
        "count"] == 1


class Wall:
    now = 1_700_000_000.0

    @classmethod
    def time(cls) -> float:
        return cls.now


@pytest.mark.parametrize("slo", [False, True])
def test_fleet_status_matches_reference(monkeypatch, slo):
    """Two collectors (one per package) ingest the same payloads — two
    snapshots per component, so the goodput rates come from a delta — and
    give the same fleet view; with an SLO monitor its status rides along."""
    from dynamo_tpu.runtime import slo as ref_slo
    from dynamo_tpu_torch.runtime import slo as t_slo

    payloads = []
    for i, (comp, role) in enumerate((("ns/backend", "worker"),
                                      ("ns/backend", "worker"),
                                      ("frontend", "frontend"))):
        for k in range(2):
            snap = t_tel.snapshot_metrics(populate(t_metrics, 10 * i + k))
            payloads.append({"component": comp, "instance": f"{i:x}",
                             "role": role, "at": Wall.now - 5.0 + k,
                             "metrics": snap})
    out = {}
    for pkg, (tel, _), slo_mod in (("ref", PKGS["ref"], ref_slo),
                                   ("torch", PKGS["torch"], t_slo)):
        monkeypatch.setattr(tel, "time", Wall)
        mon = None
        if slo:
            mon = slo_mod.SloMonitor([slo_mod.SloObjective("ttft", 0.1)],
                                     clock=lambda: 5.0)
            mon.observe("ttft", 0.5)
            mon.evaluate()
        col = tel.TelemetryCollector(bus=None)
        for p in payloads:
            col.ingest(json.loads(json.dumps(p)))
        out[pkg] = col.fleet_status(slo=mon, control=None, brownout=None)
    assert out["torch"] == out["ref"]
    st = out["torch"]
    assert len(st["components"]) == 3 and st["fleet"]["goodput"][
        "goodput_tok_s"] > 0
    assert ("slo" in st) is slo


def test_engine_histogram_edges_equal_the_reference():
    """Every histogram both engines publish under one name has one set of
    edges: a mixed fleet's merge never skips a family."""
    reg_t, reg_r = t_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    EngineMetrics().register(reg_t)
    RefEngineMetrics().register(reg_r)
    hist_t = {n: m.buckets for n, m in reg_t.collect().items()
              if isinstance(m, t_metrics.Histogram)}
    hist_r = {n: m.buckets for n, m in reg_r.collect().items()
              if isinstance(m, ref_metrics.Histogram)}
    common = set(hist_t) & set(hist_r)
    assert {"dynamo_engine_ttft_seconds", "dynamo_engine_itl_ms",
            "dynamo_engine_prefill_chunk_seconds"} <= common
    for name in common:
        assert hist_t[name] == hist_r[name], name


def test_mixed_fleet_publishes_and_collects_across_packages(monkeypatch):
    """Over one coordinator: a port worker and a JAX-package worker, each
    with `telemetry_interval` 0.2 s, and a frontend of each package. Both
    frontends' /fleet/status list both workers and both frontends, and the
    merged engine TTFT count is the sum of the workers' own counts."""
    from dynamo_tpu.llm import entrypoint as ref_entry
    from dynamo_tpu.llm import model_card as ref_card
    from dynamo_tpu.runtime import config as ref_config
    from dynamo_tpu.runtime import distributed as ref_dist
    from dynamo_tpu_torch.llm import entrypoint as t_entry
    from dynamo_tpu_torch.llm import model_card as t_card
    from dynamo_tpu_torch.runtime import config as t_config
    from dynamo_tpu_torch.runtime import distributed as t_dist
    from tests.test_torch_serving import StoreThread, _card, _engines, call

    jax_eng, torch_eng = _engines()

    async def main(url):
        # a runtime each: a frontend's snapshot must not carry a
        # worker's engine series
        rts = [await dist.DistributedRuntime.create(
                   cfg.RuntimeConfig(store_url=url, telemetry_interval=0.2))
               for dist, cfg in ((ref_dist, ref_config), (t_dist, t_config),
                                 (ref_dist, ref_config),
                                 (t_dist, t_config))]
        handles, fes = [], []
        try:
            handles.append(await ref_entry.serve_engine(
                rts[0], jax_eng, _card(ref_card, "tiny-jax", "jax_backend"),
                instance_id=1))
            handles.append(await t_entry.serve_engine(
                rts[1], torch_eng, _card(t_card, "tiny-torch",
                                         "torch_backend"), instance_id=2))
            fes.append(await ref_entry.start_frontend(
                rts[2], port=0, router_mode_override="round_robin"))
            fes.append(await t_entry.start_frontend(
                rts[3], port=0, router_mode_override="round_robin"))
            for fe in fes:
                while not {"tiny-jax", "tiny-torch"} <= set(
                        fe.manager.model_names()):
                    await asyncio.sleep(0.02)
            for model in ("tiny-jax", "tiny-torch"):
                st, _, _ = await call(fes[1].http.port, "POST",
                                      "/v1/chat/completions",
                                      {"model": model, "max_tokens": 4,
                                       "messages": [{"role": "user",
                                                     "content": "hi"}]})
                assert st == 200
            views = []
            for fe in fes:
                for _ in range(100):
                    _, _, raw = await call(fe.http.port, "GET",
                                           "/fleet/status")
                    view = json.loads(raw)
                    lat = view["fleet"]["latency"].get("ttft", {})
                    if len(view["components"]) == 4 and \
                            lat.get("count") == 2:
                        break
                    await asyncio.sleep(0.1)
                views.append(view)
            return views
        finally:
            for fe in fes:
                await fe.stop()
            for h in handles:
                await h.stop()
            await jax_eng.close()
            await torch_eng.close()
            for rt in rts:
                await rt.close()

    with StoreThread() as store:
        views = asyncio.run(asyncio.wait_for(main(store.url), 100))
    for view in views:
        comps = sorted((c["component"], c["role"])
                       for c in view["components"])
        assert comps == [("dynamo/jax_backend", "worker"),
                         ("dynamo/torch_backend", "worker"),
                         ("frontend", "frontend"), ("frontend", "frontend")]
        ttft = view["fleet"]["latency"]["ttft"]
        assert ttft["source"] == "dynamo_engine_ttft_seconds"
        assert ttft["count"] == 2
        workers = [c for c in view["components"] if c["role"] == "worker"]
        assert all(c["latency"]["ttft"]["count"] == 1 for c in workers)


def test_fleet_status_is_503_without_a_collector():
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.llm.model_manager import ModelManager
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from tests.test_torch_serving import call

    async def main():
        rt = await DistributedRuntime.create(RuntimeConfig())
        manager = ModelManager(rt)
        http = HttpService(manager, port=0)
        await http.start()
        try:
            return await call(http.port, "GET", "/fleet/status")
        finally:
            await http.stop()
            await manager.close()
            await rt.close()

    st, _, raw = asyncio.run(asyncio.wait_for(main(), 30))
    assert st == 503
    assert json.loads(raw) == {"status": "unavailable",
                               "reason": "telemetry collector not running"}
