"""The port's worker and frontend CLIs refuse what they cannot serve: each
reference flag whose subsystem is not ported yet (the multi-device
flags, `--grpc-port`), set, exits with a message that names what it
waits for (none is ignored); the `kv` router mode and the frontend's
KV-router flags are accepted; `--faults` / `--faults-seed` are served by
every component and `--mock*` by the worker; the status server,
health-check and adaptive-idle flags parse and reach the runtime's
config on both CLIs; `--telemetry-interval` (worker and frontend) and
the frontend's eight `--slo-*` flags parse into the runtime's config and
reach the telemetry publisher and the SLO monitor; the worker on
`--device cuda` without a card raises instead of serving on the CPU."""

import asyncio
import os
import subprocess
import sys

import pytest

from dynamo_tpu_torch.frontend import __main__ as frontend_main
from dynamo_tpu_torch.worker import main as worker_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--echo", "--router-mode", "round_robin"]


def _value(kind: str) -> list:
    return {"store_true": [], "int>1": ["2"], "value": ["1"]}[kind]


@pytest.mark.parametrize("flag", sorted(worker_main.WORKER_REFUSED))
def test_worker_refuses_unported_flag(flag):
    waits_for, kind = worker_main.WORKER_REFUSED[flag]
    args = worker_main.parse_args(BASE + [flag] + _value(kind))
    with pytest.raises(SystemExit) as e:
        worker_main.check_args(args)
    msg = str(e.value)
    assert flag in msg and waits_for in msg


# flags the worker serves since KVBM and the prefill queue were ported:
# parsed under the reference's names and accepted
SERVED_FLAGS = {"--prefill-queue": ([], "prefill_queue", True),
                "--kvbm-host-blocks": (["64"], "kvbm_host_blocks", 64),
                "--kvbm-offload-queue": (["8"], "kvbm_offload_queue", 8),
                "--kvbm-offload-workers": (["2"], "kvbm_offload_workers", 2),
                "--kvbm-prefetch-blocks": (["4"], "kvbm_prefetch_blocks", 4),
                "--kvbm-offload-queue-bytes": (["1024"],
                                               "kvbm_offload_queue_bytes",
                                               1024)}


@pytest.mark.parametrize("flag", sorted(SERVED_FLAGS))
def test_worker_serves_kvbm_and_queue_flags(flag, monkeypatch):
    """Each flag parses and passes the checks with a model; an unset
    pipeline flag falls back to its DYN_KVBM_* runtime-config field."""
    value, dest, want = SERVED_FLAGS[flag]
    assert flag not in worker_main.WORKER_REFUSED
    args = worker_main.parse_args(["--model", "x", "--router-mode",
                                   "round_robin", flag] + value)
    worker_main.check_args(args)
    assert getattr(args, dest) == want
    if dest.startswith("kvbm_") and dest != "kvbm_host_blocks":
        monkeypatch.setenv("DYN_" + dest.upper(), "3")
        args = worker_main.parse_args(["--model", "x"])
        worker_main.apply_kvbm_defaults(
            args, worker_main.runtime_config_from_args(args))
        assert getattr(args, dest) == 3
    if dest == "kvbm_host_blocks":
        with pytest.raises(SystemExit, match="KVBM needs --model"):
            worker_main.check_args(worker_main.parse_args(
                BASE + [flag] + value))


@pytest.mark.parametrize("flag", sorted(frontend_main.FRONTEND_REFUSED))
def test_frontend_refuses_unported_flag(flag, monkeypatch):
    waits_for, kind = frontend_main.FRONTEND_REFUSED[flag]
    started = []
    monkeypatch.setattr(frontend_main, "run_until_signal",
                        lambda *a, **k: started.append(a))
    with pytest.raises(SystemExit) as e:
        frontend_main.main([flag] + _value(kind))
    msg = str(e.value)
    assert flag in msg and waits_for in msg
    assert not started


@pytest.mark.parametrize("flag,value", [("--tensor-parallel-size", "1"),
                                        ("--num-nodes", "1"),
                                        ("--expert-parallel-size", "1")])
def test_worker_accepts_single_device_defaults(flag, value):
    worker_main.check_args(worker_main.parse_args(BASE + [flag, value]))


def test_kv_router_mode_and_flags_are_accepted(monkeypatch):
    """The worker's default router mode is kv and passes its checks; the
    frontend's four KV-router flags reach the router's config."""
    args = worker_main.parse_args(["--echo"])
    assert args.router_mode == "kv"
    worker_main.check_args(args)
    flags = ["--router-mode", "kv", "--kv-overlap-score-weight", "2.5",
             "--router-temperature", "0.3", "--no-kv-events",
             "--router-replica-sync"]
    cfg = frontend_main.router_config_from_args(
        frontend_main.parse_args(flags))
    assert (cfg.overlap_weight, cfg.temperature, cfg.use_kv_events,
            cfg.replica_sync) == (2.5, 0.3, False, True)
    started = []
    monkeypatch.setattr(frontend_main, "run_until_signal",
                        lambda *a, **k: started.append(a))
    frontend_main.main(flags)
    assert len(started) == 1


def test_worker_on_cuda_without_a_card_raises(tmp_path):
    from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint

    ckpt = write_synthetic_hf_checkpoint(str(tmp_path / "tiny"),
                                         preset="tiny")
    args = worker_main.parse_args(["--model", ckpt, "--router-mode",
                                   "round_robin"])
    assert args.device == "cuda"
    worker_main.check_args(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_main.build_engine_and_card(args)


def test_worker_cli_exits_nonzero_on_refusal():
    # a flag of a part still to port (--draft-model, refused here before
    # speculative decoding was ported, is served now)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.worker", "--echo",
         "--router-mode", "round_robin", "--sp-degree", "2"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--sp-degree" in proc.stderr
    assert "multi-device paths" in proc.stderr


SPEC_FLAGS = {"--draft-model": (["/d"], "draft_model", "/d"),
              "--spec-gamma": (["3"], "spec_gamma", 3),
              "--spec-iters-per-sync": (["2"], "spec_iters_per_sync", 2)}


@pytest.mark.parametrize("flag", sorted(SPEC_FLAGS))
def test_worker_serves_spec_flags(flag):
    """Speculative decoding's flags parse under the reference's names and
    defaults and pass the checks with a model; a draft needs a target."""
    value, dest, want = SPEC_FLAGS[flag]
    assert flag not in worker_main.WORKER_REFUSED
    defaults = worker_main.parse_args(["--model", "x"])
    assert (defaults.draft_model, defaults.spec_gamma,
            defaults.spec_iters_per_sync) == (None, 4, 8)
    args = worker_main.parse_args(["--model", "x", "--router-mode",
                                   "round_robin", flag] + value)
    worker_main.check_args(args)
    assert getattr(args, dest) == want
    if flag == "--draft-model":
        with pytest.raises(SystemExit, match="needs --model"):
            worker_main.check_args(worker_main.parse_args(
                BASE + [flag] + value))


# the runtime flags served since the status server, the health canaries
# and the adaptive idle timeout were ported: flag -> (argv, config field,
# value it takes)
STATUS_FLAGS = {
    "--system-port": (["0"], "system_port", 0),
    "--health-check": ([], "health_check_enabled", True),
    "--health-check-interval": (["1.5"], "health_check_interval", 1.5),
    "--health-check-timeout": (["2.5"], "health_check_timeout", 2.5),
    "--stream-idle-adaptive-margin": (["4"], "stream_idle_adaptive_margin",
                                      4.0),
}


@pytest.mark.parametrize("flag", sorted(STATUS_FLAGS))
def test_status_and_health_flags_are_served(flag, monkeypatch):
    """Each flag parses on the worker and the frontend, passes their
    checks, and sets its RuntimeConfig field; unset, the field keeps its
    default (or its DYN_* variable)."""
    from dynamo_tpu_torch.cli_util import runtime_config_from_args
    from dynamo_tpu_torch.runtime.config import RuntimeConfig

    value, field, want = STATUS_FLAGS[flag]
    args = worker_main.parse_args(BASE + [flag] + value)
    worker_main.check_args(args)
    assert getattr(runtime_config_from_args(args), field) == want
    assert getattr(runtime_config_from_args(worker_main.parse_args(BASE)),
                   field) == getattr(RuntimeConfig(), field)
    started = []
    monkeypatch.setattr(frontend_main, "run_until_signal",
                        lambda *a, **k: started.append(a))
    frontend_main.main([flag] + value)
    assert len(started) == 1
    fargs = frontend_main.parse_args([flag] + value)
    assert getattr(runtime_config_from_args(fargs), field) == want


# the observability flags served since the SLO monitor and the telemetry
# plane were ported: (CLI, flag) -> (argv value, config field, value it
# takes)
OBSERVABILITY_FLAGS = {
    ("worker", "--telemetry-interval"): ("0.5", "telemetry_interval", 0.5),
    ("frontend", "--telemetry-interval"): ("0.5", "telemetry_interval",
                                           0.5),
    ("frontend", "--slo-ttft"): ("0.25", "slo_ttft", 0.25),
    ("frontend", "--slo-itl"): ("0.04", "slo_itl", 0.04),
    ("frontend", "--slo-target-ratio"): ("0.95", "slo_target_ratio", 0.95),
    ("frontend", "--slo-fast-window"): ("30", "slo_fast_window", 30.0),
    ("frontend", "--slo-slow-window"): ("300", "slo_slow_window", 300.0),
    ("frontend", "--slo-fast-burn"): ("10", "slo_fast_burn", 10.0),
    ("frontend", "--slo-slow-burn"): ("3", "slo_slow_burn", 3.0),
    ("frontend", "--slo-check-interval"): ("0.5", "slo_check_interval",
                                           0.5),
}


@pytest.mark.parametrize("cli,flag", sorted(OBSERVABILITY_FLAGS))
def test_observability_flags_are_served(cli, flag, monkeypatch):
    """Each flag parses, passes the CLI's checks, sets its RuntimeConfig
    field, and reaches its subsystem: the worker's or the frontend's
    TelemetryPublisher runs at the interval; the frontend's SloMonitor
    holds the objective (an objective flag alone arms it; a window, burn
    or ratio flag is read beside a TTFT objective) and its loop runs at
    the check interval."""

    from dynamo_tpu_torch.cli_util import runtime_config_from_args
    from dynamo_tpu_torch.engines import EchoEngine
    from dynamo_tpu_torch.llm import entrypoint as t_entry
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    value, field, want = OBSERVABILITY_FLAGS[(cli, flag)]
    assert flag not in frontend_main.FRONTEND_REFUSED
    if cli == "worker":
        args = worker_main.parse_args(BASE + [flag, value])
        worker_main.check_args(args)
    else:
        started = []
        monkeypatch.setattr(frontend_main, "run_until_signal",
                            lambda *a, **k: started.append(a))
        frontend_main.main([flag, value])
        assert len(started) == 1
        extra = ([] if field in ("slo_ttft", "slo_itl", "telemetry_interval")
                 else ["--slo-ttft", "0.1"])
        args = frontend_main.parse_args([flag, value] + extra)
    cfg = runtime_config_from_args(args)
    assert getattr(cfg, field) == want

    async def main():
        rt = await DistributedRuntime.create(cfg)
        try:
            if cli == "worker":
                card = ModelDeploymentCard(name="echo",
                                           router_mode="round_robin")
                h = await t_entry.serve_engine(rt, EchoEngine(), card)
                got = h.publisher.interval
                await h.stop()
                return got
            fe = await t_entry.start_frontend(rt, port=0)
            try:
                if field == "telemetry_interval":
                    return fe.publisher.interval
                mon, (obj,) = fe.slo, fe.slo._tracks.values()
                return {"slo_ttft": obj.objective.threshold,
                        "slo_itl": obj.objective.threshold,
                        "slo_target_ratio": obj.objective.target_ratio,
                        "slo_fast_window": mon.fast_window,
                        "slo_slow_window": mon.slow_window,
                        "slo_fast_burn": mon.fast_threshold,
                        "slo_slow_burn": mon.slow_threshold,
                        "slo_check_interval": cfg.slo_check_interval
                        if fe._slo_task is not None else None}[field]
            finally:
                await fe.stop()
        finally:
            await rt.close()

    assert asyncio.run(asyncio.wait_for(main(), 30)) == want


# the components that take --faults / --faults-seed since the fault
# injector's wire, store and engine hooks were ported
FAULT_CLIS = ("worker", "frontend", "router", "coordinator", "run")


class _RuntimeReached(Exception):
    pass


@pytest.mark.parametrize("cli", FAULT_CLIS)
def test_faults_flags_are_served(cli, monkeypatch):
    """`--faults SPEC --faults-seed N` parse on every component and reach
    the environment as DYN_FAULTS / DYN_FAULTS_SEED (what every injector
    of the process and its children reads), as the reference's
    cli_util exports them. The frontend and the router are driven up to
    `DistributedRuntime.create`, which builds the TransportClient and its
    injector: the spec must be exported by then."""
    from dynamo_tpu_torch.coordinator import __main__ as coord_main
    from dynamo_tpu_torch.router import __main__ as router_main
    from dynamo_tpu_torch.run import main as run_main
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.faults import FaultInjector

    spec = "kind=connect_refused,addr=*:1,times=1;kind=disconnect,after=2"
    flags = ["--faults", spec, "--faults-seed", "7"]
    for var in ("DYN_FAULTS", "DYN_FAULTS_SEED"):
        # recorded by setenv, so the exported spec is undone afterwards
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    if cli == "worker":
        args = worker_main.parse_args(BASE + flags)
        worker_main.check_args(args)
        worker_main.runtime_config_from_args(args)
    elif cli in ("frontend", "router"):
        mod = frontend_main if cli == "frontend" else router_main
        seen = {}

        async def create(*a, **k):
            seen.update({v: os.environ.get(v)
                         for v in ("DYN_FAULTS", "DYN_FAULTS_SEED")})
            raise _RuntimeReached

        monkeypatch.setattr(DistributedRuntime, "create", create)
        monkeypatch.setattr(mod, "run_until_signal",
                            lambda start, **k: asyncio.run(start()))
        with pytest.raises(_RuntimeReached):
            mod.main(flags)
        assert seen == {"DYN_FAULTS": spec, "DYN_FAULTS_SEED": "7"}
    elif cli == "coordinator":
        monkeypatch.setattr(coord_main.asyncio, "run",
                            lambda coro: coro.close())
        coord_main.main(flags)
    else:
        monkeypatch.setattr(run_main.asyncio, "run",
                            lambda coro: coro.close())
        run_main.main(["in=text:hi", "out=torch:/nope"] + flags)
    assert os.environ["DYN_FAULTS"] == spec
    assert os.environ["DYN_FAULTS_SEED"] == "7"
    inj = FaultInjector.from_env()
    assert [r.kind for r in inj.rules] == ["connect_refused", "disconnect"]


MOCK_FLAGS = {"--mock-speedup": (["8"], "speedup", 8.0),
              "--mock-decode-ms": (["2.5"], "decode_ms_per_iter", 2.5),
              "--mock-total-blocks": (["96"], "total_kv_blocks", 96)}


@pytest.mark.parametrize("flag", sorted(MOCK_FLAGS))
def test_worker_serves_mock_flags(flag):
    """`--mock` and its knobs parse under the reference's names and
    defaults and build the mocker: card `mock-model` with the word
    tokenizer, the instance id as the engine's worker id; the mocker
    holds no KV a disagg or KVBM worker could move."""
    from dynamo_tpu_torch.mocker import MockEngine

    value, field, want = MOCK_FLAGS[flag]
    assert flag not in worker_main.WORKER_REFUSED
    defaults = worker_main.parse_args(["--mock"])
    assert (defaults.mock_speedup, defaults.mock_decode_ms,
            defaults.mock_total_blocks) == (1.0, 4.0, 1024)
    args = worker_main.parse_args(["--mock", "--instance-id", "5", flag]
                                  + value)
    worker_main.check_args(args)
    engine, card = worker_main.build_engine_and_card(args)
    assert isinstance(engine, MockEngine)
    assert getattr(engine.config, field) == want
    assert (card.name, card.tokenizer_kind, engine.config.worker_id,
            engine.config.block_size) == ("mock-model", "word", 5,
                                          card.kv_block_size)
    with pytest.raises(SystemExit, match="mocker engine holds no KV"):
        worker_main.check_args(worker_main.parse_args(
            ["--mock", "--kvbm-host-blocks", "4"]))
