"""The port's structured logging (`dynamo_tpu_torch/runtime/logging_util.py`)
held against the JAX package's (`dynamo_tpu/runtime/logging_util.py`).

- `JsonlFormatter` renders the same JSON object for the same record
  (extra `fields` and an exception included), and `init_logging` reads
  `DYN_LOG` specs into the same root and per-module levels.
- The worker CLI under `DYN_LOG_FORMAT=jsonl` writes only JSON lines on
  stderr (Python warnings included), and its `setup_logging` is
  `init_logging`.
"""

import json
import logging
import os
import subprocess
import sys

import pytest

from dynamo_tpu.runtime import logging_util as ref_log
from dynamo_tpu_torch.runtime import logging_util as t_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record(exc: bool, fields: bool) -> logging.LogRecord:
    exc_info = None
    if exc:
        try:
            raise ValueError("bad value")
        except ValueError:
            exc_info = sys.exc_info()
    rec = logging.LogRecord("dynamo_tpu_torch.engine", logging.WARNING,
                            __file__, 7, "stalled %d s", (3,), exc_info)
    if fields:
        rec.fields = {"request_id": "r1", "tokens": 4}
    return rec


@pytest.mark.parametrize("exc", [False, True])
@pytest.mark.parametrize("fields", [False, True])
def test_jsonl_formatter_matches_reference(exc, fields, monkeypatch):
    monkeypatch.setattr(t_log.time, "time", lambda: 1.25)
    got = json.loads(t_log.JsonlFormatter().format(_record(exc, fields)))
    want = json.loads(ref_log.JsonlFormatter().format(_record(exc, fields)))
    assert got == want
    assert got["message"] == "stalled 3 s" and got["level"] == "WARNING"
    assert ("exception" in got) is exc and ("request_id" in got) is fields


@pytest.mark.parametrize("spec", [
    "info", "debug", "warning,dynamo_tpu_torch.router=debug",
    "dynamo_tpu_torch.engine=error,dynamo_tpu_torch.kvbm=info,debug"])
@pytest.mark.parametrize("fmt", ["text", "jsonl"])
def test_init_logging_levels_match_reference(spec, fmt, monkeypatch):
    monkeypatch.setenv("DYN_LOG_FORMAT", fmt)
    names = ("", "dynamo_tpu_torch.router", "dynamo_tpu_torch.engine",
             "dynamo_tpu_torch.kvbm")
    root = logging.getLogger()
    saved = (root.handlers[:], root.level,
             {n: logging.getLogger(n).level for n in names[1:]})
    try:
        levels = {}
        for pkg, mod in (("ref", ref_log), ("torch", t_log)):
            for n in names[1:]:
                logging.getLogger(n).setLevel(logging.NOTSET)
            mod.init_logging(spec)
            levels[pkg] = ([logging.getLogger(n).level for n in names],
                           type(root.handlers[0].formatter).__name__)
        assert levels["torch"] == levels["ref"]
    finally:
        root.handlers[:], lvl, mods = saved
        root.setLevel(lvl)
        for n, v in mods.items():
            logging.getLogger(n).setLevel(v)
        logging.captureWarnings(False)


def test_worker_cli_writes_json_lines_only(tmp_path):
    """An echo worker over the in-process store, started and stopped
    under DYN_LOG_FORMAT=jsonl with a Python warning raised at start:
    every stderr line is a JSON object."""
    probe = (
        "import signal, threading, os, warnings, sys\n"
        "warnings.warn('a library warning')\n"
        "threading.Timer(3.0, lambda: os.kill(os.getpid(), "
        "signal.SIGTERM)).start()\n"
        "sys.argv = ['worker', '--echo', '--router-mode', 'round_robin']\n"
        "from dynamo_tpu_torch.worker.main import main\n"
        "main()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, DYN_LOG_FORMAT="jsonl")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import logging\n"
         "from dynamo_tpu_torch.cli_util import setup_logging\n"
         "setup_logging('info')\n" + probe],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stderr.splitlines() if ln.strip()]
    rows = [json.loads(ln) for ln in lines]
    assert rows and all({"ts", "level", "target", "message"} <= set(r)
                        for r in rows)
    assert any("a library warning" in r["message"] for r in rows)
    assert "WORKER_READY" in proc.stdout
