"""Structured metrics logging (JSONL): the port's own copy of
``tinydiffusionmodels_tpu/train/metrics.py``.

Every train loop can emit machine-readable epoch records to a JSONL file
(one object per line: timestamped losses, throughput), enabled via
``metrics_path=`` or ``TDM_METRICS_PATH``. Works for local paths and gs://
(buffered, uploaded on close).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from tinydiffusionmodels_torch.io.storage import is_gcs_path, save_samples


class MetricsLogger:
    def __init__(self, path: str | os.PathLike | None = None):
        self.path = str(path) if path else os.environ.get("TDM_METRICS_PATH")
        self._rows: list[str] = []
        self._t0 = time.time()

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def log(self, record: dict[str, Any]) -> None:
        if not self.enabled:
            return
        row = json.dumps(
            {"t": round(time.time() - self._t0, 3), **record},
            sort_keys=True,
        )
        self._rows.append(row)
        if not is_gcs_path(self.path):
            # Local: append incrementally so tail -f works mid-run.
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(row + "\n")

    def close(self) -> None:
        if self.enabled and is_gcs_path(self.path) and self._rows:
            save_samples("\n".join(self._rows) + "\n", self.path)
