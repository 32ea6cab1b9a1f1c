"""Structured JSONL logging (reference: `lib/runtime/src/logging.rs`).

Port of `dynamo_tpu/runtime/logging_util.py` (the port keeps its own
copy).

JSONL to stderr when DYN_LOG_FORMAT=jsonl (the reference's default for
production); human-readable otherwise. Level from DYN_LOG (e.g. "debug",
"dynamo_tpu_torch.router=debug,info").
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            entry.update(extra)
        return json.dumps(entry)


def init_logging(level: str | None = None) -> None:
    spec = level or os.environ.get("DYN_LOG", "info")
    fmt = os.environ.get("DYN_LOG_FORMAT", "text")
    handler = logging.StreamHandler(sys.stderr)
    if fmt == "jsonl":
        handler.setFormatter(JsonlFormatter())
        # Python warnings (a library's UserWarning) go through the same
        # handler, so every line on stderr stays JSON
        logging.captureWarnings(True)
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(name)s: %(message)s"))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    # spec: "info" or "mod=debug,mod2=warn,info"
    default = "INFO"
    for part in spec.split(","):
        if "=" in part:
            mod, lvl = part.split("=", 1)
            logging.getLogger(mod).setLevel(lvl.upper())
        else:
            default = part.upper()
    root.setLevel(default)
