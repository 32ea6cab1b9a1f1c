"""The port's checkpoint path and launcher: `config_from_hf` /
`load_llama_params` against the JAX loader on synthetic checkpoints
written by dynamo_tpu/models/synth_ckpt.py (Llama and Qwen2 with q/k/v
biases) — every tensor bit-exact; the port's own safetensors reader
against the `safetensors` package; and `python -m dynamo_tpu_torch.run`
in a subprocess on the CPU, which must serve without importing jax or any
dynamo_tpu module."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.convert import tensor_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    return {p: write_synthetic_hf_checkpoint(str(root / p), preset=p)
            for p in ("tiny", "qwen2-tiny", "mixtral-tiny")}


@pytest.mark.parametrize("preset", ["tiny", "qwen2-tiny"])
def test_config_and_weights_match_jax_loader(ckpts, preset):
    path = ckpts[preset]
    jcfg = jloader.config_from_hf(path)
    tcfg = tloader.config_from_hf(path)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "num_kv_heads", "head_dim", "rope_theta",
              "rms_eps", "attention_bias", "page_size", "max_pages_per_seq"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    assert tcfg.attention_bias is (preset == "qwen2-tiny")

    tree = jloader.load_llama_params(path, jcfg)
    model = tloader.load_llama_params(path, tcfg, "cpu")

    def same(t, a):
        want = tensor_from_numpy(a)
        assert t.dtype == want.dtype and torch.equal(t, want)

    same(model.embed, tree["embed"])
    same(model.lm_head, tree["lm_head"])
    same(model.final_norm, tree["final_norm"])
    for key, stack in tree["layers"].items():
        for l, layer in enumerate(model.layers):
            same(getattr(layer, key), stack[l])


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.integers(-9, 9, (7,)).astype(np.int64),
              "c": rng.standard_normal((2, 2, 2)).astype(np.float16)}
    save_file(arrays, str(tmp_path / "x.safetensors"))
    sf = tloader.SafetensorsFile(str(tmp_path / "x.safetensors"))
    try:
        assert sorted(sf.keys()) == ["a", "b", "c"]
        for k, a in arrays.items():
            assert np.array_equal(sf.get(k).numpy(), a)
    finally:
        sf.close()


def test_mixtral_checkpoint_is_refused(tmp_path):
    """Mixtral checkpoints are served since MoE was ported
    (tests/test_torch_moe.py); one whose config cannot size its expert
    stacks (no num_local_experts) is refused, as the reference refuses
    it."""
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["MixtralForCausalLM"], "hidden_size": 8,
        "num_attention_heads": 2, "intermediate_size": 8,
        "num_hidden_layers": 1, "vocab_size": 8}))
    with pytest.raises(ValueError, match="num_local_experts"):
        tloader.config_from_hf(str(tmp_path))
    with pytest.raises(ValueError, match="num_local_experts"):
        jloader.config_from_hf(str(tmp_path))


def test_cli_serves_on_cpu_without_jax(ckpts):
    """`python -m dynamo_tpu_torch.run in=text:hi out=torch:<ckpt>
    --device cpu` in a fresh interpreter, on the default (phase) path: it
    answers, every engine dispatch was a phase-path one (prefill rounds
    and decode bursts); then an int4 engine built from the same checkpoint
    serves a request, its compile tracker holding its entries; then a
    guided chat request (nvext guided_choice, with a presence penalty)
    goes through the OpenAI pipeline to a fresh engine and its text is one
    of the choices; then the worker CLI's start path serves a Mixtral
    checkpoint (int8 experts) that answers a request, and an encode
    worker that encodes a PNG; and at the end, with the compiled-step modules
    (graphs, compile tracker, bucket ladder, metrics) and the guided ones
    (grammar compiler, compute pool) loaded too, no jax and no dynamo_tpu
    module was ever imported."""
    probe = (
        "import runpy, sys\n"
        "from dynamo_tpu_torch.models import llama\n"
        "calls = []\n"
        "for name in ('prefill_batch', 'decode_multi_step', "
        "'mixed_prefill_decode', 'ragged_prefill_decode'):\n"
        "    def spy(*a, _f=getattr(llama, name), _n=name, **k):\n"
        "        calls.append(_n)\n"
        "        return _f(*a, **k)\n"
        "    setattr(llama, name, spy)\n"
        "import dynamo_tpu_torch.engine.engine as eng\n"
        "for name in ('prefill_batch', 'decode_multi_step', "
        "'mixed_prefill_decode', 'ragged_prefill_decode'):\n"
        "    setattr(eng, name, getattr(llama, name))\n"
        "sys.argv = ['dynamo_tpu_torch.run', 'in=text:hi', "
        f"'out=torch:{ckpts['tiny']}', '--device', 'cpu', "
        "'--max-tokens', '5']\n"
        "runpy.run_module('dynamo_tpu_torch.run', run_name='__main__')\n"
        "import asyncio\n"
        "from dynamo_tpu_torch.engine.quant import QTensor\n"
        "from dynamo_tpu_torch.llm.entrypoint import build_torch_engine\n"
        "from dynamo_tpu_torch.runtime.context import Context\n"
        f"q_eng, _ = build_torch_engine({ckpts['tiny']!r}, quantize='int4', "
        "num_pages=16, device='cpu')\n"
        "assert isinstance(q_eng.model.layers[0].w_up, QTensor)\n"
        "assert q_eng.model.layers[0].w_up.bits == 4\n"
        "async def serve():\n"
        "    toks = []\n"
        "    try:\n"
        "        async for o in q_eng.generate({'token_ids': [5, 6, 7], "
        "'sampling': {'temperature': 0.0}, 'stop': {'max_tokens': 3}}, "
        "Context()):\n"
        "            toks += o.get('token_ids', [])\n"
        "    finally:\n"
        "        await q_eng.close()\n"
        "    return toks\n"
        "print('INT4', len(asyncio.run(serve())))\n"
        "print('TRACKED', sorted({k[0] for k in "
        "q_eng.compile_tracker._seen}))\n"
        "from dynamo_tpu_torch.run.main import build_pipeline_for\n"
        f"g_eng, card = build_torch_engine({ckpts['tiny']!r}, 'tiny', "
        "num_pages=16, device='cpu')\n"
        "args = type('A', (), {'tokenizer': 'auto', "
        "'context_length': None, 'max_tokens': 8})()\n"
        "async def guided():\n"
        "    pipe = build_pipeline_for(card, g_eng, args)\n"
        "    body = {'model': 'tiny', 'stream': True, 'max_tokens': 8, "
        "'presence_penalty': 0.5, 'messages': [{'role': 'user', "
        "'content': 'pick'}], 'nvext': {'guided_choice': ['yes', 'no']}}\n"
        "    parts = []\n"
        "    try:\n"
        "        async for ch in pipe.generate({'_kind': 'chat', "
        "'body': body}, Context()):\n"
        "            for c in ch.get('choices', ()):\n"
        "                parts.append(c.get('delta', {}).get('content') "
        "or '')\n"
        "    finally:\n"
        "        await g_eng.close()\n"
        "    return ''.join(parts)\n"
        "print('GUIDED', repr(asyncio.run(guided())), sorted({k[0] for k "
        "in g_eng.compile_tracker._seen}))\n"
        "from dynamo_tpu_torch.worker import main as wm\n"
        "import struct, zlib\n"
        "def png(w, h):\n"
        "    def chunk(k, b):\n"
        "        return (struct.pack('>I', len(b)) + k + b + "
        "struct.pack('>I', zlib.crc32(k + b)))\n"
        "    rows = b''.join(b'\\x00' + bytes((x * 7 + y * 3 + c) % 256 "
        "for x in range(w) for c in range(3)) for y in range(h))\n"
        "    return (b'\\x89PNG\\r\\n\\x1a\\n' + chunk(b'IHDR', "
        "struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)) + chunk(b'IDAT', "
        "zlib.compress(rows)) + chunk(b'IEND', b''))\n"
        "async def workers():\n"
        "    got = []\n"
        f"    for argv in (['--model', {ckpts['mixtral-tiny']!r}, "
        "'--random-init', '--quantize', 'int8', '--num-pages', '32', "
        "'--device', 'cpu', '--store', 'memory', '--encode-component', "
        "'encoder'], ['--encode-worker', '--device', 'cpu', '--store', "
        "'memory', '--image-vocab-offset', '300']):\n"
        "        args = wm.parse_args(argv)\n"
        "        wm.check_args(args)\n"
        "        objs = await wm.start_worker(args)\n"
        "        try:\n"
        "            if objs[1] is not None:\n"
        "                got.append(type(objs[1].model.layers[0]).__name__)\n"
        "                async for o in objs[1].generate({'token_ids': "
        "[5, 6, 7, 310], 'sampling': {'temperature': 0.0}, 'stop': "
        "{'max_tokens': 3}}, Context()):\n"
        "                    got += o.get('token_ids', [])\n"
        "            else:\n"
        "                h = objs[2].served.engine\n"
        "                async for o in h.generate({'image': png(40, 24)}, "
        "Context()):\n"
        "                    got.append(len(o['image_tokens']))\n"
        "        finally:\n"
        "            await wm.stop_worker(objs)\n"
        "    return got\n"
        "print('WORKERS', asyncio.run(workers()))\n"
        "import dynamo_tpu_torch.engine.bucketing\n"
        "import dynamo_tpu_torch.engine.compile_tracker\n"
        "import dynamo_tpu_torch.engine.graphs\n"
        "import dynamo_tpu_torch.runtime.metrics\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'dynamo_tpu' or "
        "m.startswith('dynamo_tpu.'))\n"
        "print('LOADED', bad)\n"
        "print('CALLS', sorted(set(calls)))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DYN_ATTENTION_IMPL")}
    env["PYTHONPATH"] = REPO
    # the encode worker's random init (no first-use training here)
    env["DYN_TRAIN_ENCODER"] = "0"
    proc = subprocess.run([sys.executable, "-c", probe], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    # a Mixtral worker (int8 experts) answered, and an encode worker gave
    # 196 image tokens
    workers = next(line for line in proc.stdout.splitlines()
                   if line.startswith("WORKERS "))
    assert workers.startswith("WORKERS ['MoeLayer', ") and \
        workers.endswith(", 196]"), workers
    assert len(eval(workers[len("WORKERS "):])) == 5, workers
    assert "CALLS ['decode_multi_step', 'prefill_batch']" in proc.stdout, \
        proc.stdout
    assert "INT4 3" in proc.stdout, proc.stdout
    assert "TRACKED ['decode_burst', 'prefill', 'sample_first']" in \
        proc.stdout, proc.stdout
    assert ("GUIDED 'yes' ['decode_guided', 'prefill', 'sample_first']"
            in proc.stdout or "GUIDED 'no' ['decode_guided', 'prefill', "
            "'sample_first']" in proc.stdout), proc.stdout


@pytest.mark.parametrize("env,impl", [(None, "phase"), ("auto", "phase"),
                                      ("xla", "phase"), ("ragged", "ragged")])
def test_build_engine_honours_attention_impl_env(ckpts, monkeypatch, env,
                                                 impl):
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine

    if env is None:
        monkeypatch.delenv("DYN_ATTENTION_IMPL", raising=False)
    else:
        monkeypatch.setenv("DYN_ATTENTION_IMPL", env)
    engine, _ = build_torch_engine(ckpts["tiny"], num_pages=16,
                                   pipeline_bursts=False, device="cpu")
    assert engine.config.attention_impl == impl
    assert engine.ragged == (impl == "ragged")
    assert engine.config.pipeline_bursts is False


async def test_batch_pipeline_on_cpu(ckpts, tmp_path):
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine
    from dynamo_tpu_torch.run.main import build_pipeline_for, run_batch

    engine, card = build_torch_engine(ckpts["tiny"], "tiny", num_pages=64,
                                      max_batch_size=4,
                                      prefill_chunk_budget=16, device="cpu")
    assert card.tokenizer_kind == "byte" and card.kv_block_size == 16
    jobs = tmp_path / "jobs.jsonl"
    jobs.write_text("".join(json.dumps({"text": "x" * n}) + "\n"
                            for n in (3, 40, 17, 90, 5)))
    args = SimpleNamespace(tokenizer="auto", context_length=None,
                           max_tokens=6)
    try:
        pipeline = build_pipeline_for(card, engine, args)
        results = await run_batch(pipeline, card.name, str(jobs), 6,
                                  str(tmp_path / "out.jsonl"))
    finally:
        await engine.close()
    assert len(results) == 5
    for r in results:
        assert r["finish_reason"] in ("length", "eos")
        assert 1 <= r["completion_tokens"] <= 6
    assert len((tmp_path / "out.jsonl").read_text().splitlines()) == 5
    assert engine.pool.active_pages == 0


_FOREIGN_PROBE = (
    "import runpy, sys\n"
    "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
    "try:\n"
    "    runpy.run_module(sys.argv[0], run_name='__main__')\n"
    "finally:\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'dynamo_tpu', 'ml_dtypes', 'msgpack', "
    "'aiohttp'))\n"
    "    print('FOREIGN', bad, flush=True)\n")


class _Proc:
    """A port CLI in a fresh interpreter under the foreign-import probe;
    its stdout lines are read by a thread, its stderr goes to a file."""

    def __init__(self, tmp_path, name, module, *args, env=None):
        import queue
        import threading

        extra = env or {}
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "DYN_ATTENTION_IMPL")}
        env["PYTHONPATH"] = REPO
        env.update(extra)
        self.err_path = tmp_path / f"{name}.err"
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _FOREIGN_PROBE, module, *args],
            env=env, stdout=subprocess.PIPE, stderr=self._err, text=True)
        self.lines = queue.Queue()
        self.out = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.out.append(line)
            self.lines.put(line)

    def wait_line(self, prefix, timeout=60.0):
        import queue
        import time

        end = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, end - time.monotonic()))
            except queue.Empty:
                raise AssertionError(
                    f"no {prefix!r} line in {timeout}s; stderr: "
                    f"{self.err_path.read_text()[-2000:]}") from None
            if line.startswith(prefix):
                return line.split()[1]

    def stop(self, timeout=30.0):
        """SIGTERM; the clean exit prints the probe's FOREIGN line."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
            raise
        finally:
            self._reader.join(10)
            self._err.close()
        return rc


def _chat(url, model, **extra):
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "model": model, "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": "hi"}], **extra}),
            headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_deployment_clis_serve_on_cpu_without_foreign_imports(ckpts,
                                                              tmp_path):
    """The port's coordinator, worker (`--device cpu`) and frontend as
    three processes, and `run in=http` as one, each answer a chat request
    over HTTP; a second worker serves the same checkpoint with
    `--draft-model` (a tiny checkpoint of other weights) and answers the
    greedy chat with the same body as the worker without a draft; at
    exit none of them had loaded jax, any dynamo_tpu module, msgpack or
    aiohttp."""
    from dynamo_tpu_torch.runtime.distributed import free_port

    draft_ckpt = write_synthetic_hf_checkpoint(str(tmp_path / "draft"),
                                               preset="tiny", seed=7)

    procs = []
    try:
        coord = _Proc(tmp_path, "coordinator",
                      "dynamo_tpu_torch.coordinator", "--port",
                      str(free_port()))
        procs.append(coord)
        store = coord.wait_line("COORDINATOR_READY")
        worker = _Proc(tmp_path, "worker", "dynamo_tpu_torch.worker",
                       "--model", ckpts["tiny"], "--device", "cpu",
                       "--store", store, "--router-mode", "round_robin",
                       "--num-pages", "32", "--served-model-name", "tiny")
        procs.append(worker)
        spec = _Proc(tmp_path, "spec_worker", "dynamo_tpu_torch.worker",
                     "--model", ckpts["tiny"], "--device", "cpu",
                     "--store", store, "--router-mode", "round_robin",
                     "--num-pages", "32", "--served-model-name",
                     "tiny-spec", "--draft-model", draft_ckpt,
                     "--spec-gamma", "3", "--spec-iters-per-sync", "2")
        procs.append(spec)
        frontend = _Proc(tmp_path, "frontend", "dynamo_tpu_torch.frontend",
                         "--store", store, "--host", "127.0.0.1",
                         "--port", str(free_port()))
        procs.append(frontend)
        run = _Proc(tmp_path, "run", "dynamo_tpu_torch.run", "in=http",
                    f"out=torch:{ckpts['tiny']}", "--device", "cpu",
                    "--num-pages", "32", "--model-name", "tiny-run",
                    "--port", str(free_port()))
        procs.append(run)
        assert worker.wait_line("WORKER_READY").startswith(
            "dynamo/backend/generate/")
        spec.wait_line("WORKER_READY")
        url = frontend.wait_line("FRONTEND_READY")
        run_url = run.wait_line("RUN_READY")
        import time

        deadline = time.monotonic() + 30
        while True:                 # the frontend discovers the card
            status, body = _chat(url, "tiny")
            if status != 404 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 4
        deadline = time.monotonic() + 30
        while True:
            status, spec_body = _chat(url, "tiny-spec")
            if status != 404 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert status == 200, spec_body
        assert spec_body["choices"] == body["choices"]
        assert spec_body["usage"] == body["usage"]
        status, body = _chat(run_url, "tiny-run")
        assert status == 200, body
        assert body["choices"][0]["finish_reason"] == "length"
    finally:
        rcs = [p.stop() for p in reversed(procs)]
    for p, rc in zip(reversed(procs), rcs):
        assert rc == 0, p.err_path.read_text()[-3000:]
        assert "FOREIGN []\n" in p.out, (p.out, p.err_path.read_text())


def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_status_server_and_parser_card_serve_without_foreign_imports(
        ckpts, tmp_path):
    """A worker with `--system-port --health-check` (and the dispatch
    watchdog armed) answers /live, /health with its subject after idle
    canaries ran through its engine, /metrics and /config; a frontend
    with `--system-port --stream-idle-adaptive-margin` serves a card that
    names the hermes and basic parsers (published beside the worker's,
    on its endpoint) and answers a chat with tools through the jail; at
    exit neither process had loaded jax, any dynamo_tpu module, msgpack
    or aiohttp."""
    import asyncio
    import threading
    import time

    from dynamo_tpu_torch.llm.model_card import (
        MDC_PREFIX,
        ModelDeploymentCard,
        register_llm,
    )
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import (
        DistributedRuntime,
        free_port,
    )

    procs, loop, rt = [], None, None
    w_sys, f_sys = free_port(), free_port()
    try:
        coord = _Proc(tmp_path, "coordinator",
                      "dynamo_tpu_torch.coordinator", "--port",
                      str(free_port()))
        procs.append(coord)
        store = coord.wait_line("COORDINATOR_READY")
        worker = _Proc(tmp_path, "worker", "dynamo_tpu_torch.worker",
                       "--model", ckpts["tiny"], "--device", "cpu",
                       "--store", store, "--router-mode", "round_robin",
                       "--num-pages", "32", "--served-model-name", "tiny",
                       "--system-port", str(w_sys), "--health-check",
                       "--health-check-interval", "0.3",
                       env={"DYN_WATCHDOG_STALL_S": "30",
                            "DYN_TEST_SECRET": "hush"})
        procs.append(worker)
        frontend = _Proc(tmp_path, "frontend", "dynamo_tpu_torch.frontend",
                         "--store", store, "--host", "127.0.0.1",
                         "--port", str(free_port()), "--system-port",
                         str(f_sys), "--stream-idle-adaptive-margin", "3")
        procs.append(frontend)
        subject = worker.wait_line("WORKER_READY")
        url = frontend.wait_line("FRONTEND_READY")
        assert _get(f_sys, "/live") == (200, b'{"status": "live"}')
        # the parser card, published from this process on the worker's
        # endpoint (the worker has no parser flag, as the reference's)
        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True).start()

        def run(coro):
            return asyncio.run_coroutine_threadsafe(coro, loop).result(30)

        rt = run(DistributedRuntime.create(RuntimeConfig(store_url=store)))
        kvs = run(rt.store.get_prefix(MDC_PREFIX))
        card = ModelDeploymentCard.from_json(kvs[0].value)
        card.name = "tiny-tools"
        card.tool_call_parser, card.reasoning_parser = "hermes", "basic"
        run(register_llm(rt, card))
        deadline = time.monotonic() + 30
        while True:
            status, body = _chat(url, "tiny-tools", tools=[
                {"type": "function", "function": {"name": "f",
                                                  "parameters": {}}}])
            if status != 404 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert status == 200, body
        assert body["choices"][0]["finish_reason"] in ("length",
                                                      "tool_calls")
        time.sleep(1.5)                  # idle: canaries run
        status, health = _get(w_sys, "/health")
        assert status == 200, health
        health = json.loads(health)
        assert health["status"] == "healthy" and health["failing"] == []
        status, metrics = _get(w_sys, "/metrics")
        assert status == 200
        ttft = [line for line in metrics.decode().splitlines()
                if line.startswith("dynamo_engine_ttft_seconds_count")]
        assert ttft and float(ttft[0].split()[-1]) >= 2   # chat + canaries
        assert b"dynamo_watchdog_longest_stall_seconds" in metrics
        status, cfg = _get(w_sys, "/config")
        cfg = json.loads(cfg)
        assert cfg["env"]["DYN_TEST_SECRET"] == "[redacted]"
        assert cfg["runtime_config"]["health_check_enabled"] is True
        assert cfg["versions"]["torch"] == torch.__version__
        assert subject.startswith("dynamo/backend/generate/")
    finally:
        if rt is not None:
            asyncio.run_coroutine_threadsafe(rt.close(), loop).result(30)
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
        rcs = [p.stop() for p in reversed(procs)]
    for p, rc in zip(reversed(procs), rcs):
        assert rc == 0, p.err_path.read_text()[-3000:]
        assert "FOREIGN []\n" in p.out, (p.out, p.err_path.read_text())
