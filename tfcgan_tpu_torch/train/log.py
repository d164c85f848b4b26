"""Structured metric logging, port of ``tfcgan_tpu.train.log``.

JSONL records, one dict a line with a ``ts`` field first, plus a
human-readable console line rewritten in place with ``\\r``.
"""

from __future__ import annotations

import json
import os
import sys
import time


class JsonlLogger:
    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def write(self, record: dict) -> None:
        record = {"ts": time.time(), **record}
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        parts = [f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                 for k, v in record.items() if k != "ts"]
        sys.stdout.write("\r" + " | ".join(parts))
        sys.stdout.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
