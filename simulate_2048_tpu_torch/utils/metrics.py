"""Training metrics: in-memory history + JSONL sink (port of the JAX
package's ``utils/metrics.py``). Metrics stream to
``<log_dir>/metrics.jsonl`` so that runs are inspectable after the fact."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class MetricsLogger:
    """Append-only metrics log."""

    log_dir: str | None = None
    history: list[dict[str, Any]] = field(default_factory=list)
    _file: Any = None

    def __post_init__(self):
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            self._file = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def log(self, record: dict[str, Any]) -> None:
        record = {"time": time.time(), **record}
        self.history.append(record)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
