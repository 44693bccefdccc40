"""Minimal .env bootstrap (parity with reference src/__init__.py:1-2).

The port's own copy of ``tinydiffusionmodels_tpu/_env.py``, so that the
port imports nothing of the JAX package.

The reference calls ``dotenv.load_dotenv()`` on package import so that
``HF_TOKEN`` etc. are visible. We implement the tiny subset we need rather
than depending on python-dotenv: read ``.env`` from the current working
directory (and parents up to the repo root), parse KEY=VALUE lines, and set
them in ``os.environ`` without overriding existing values.
"""

from __future__ import annotations

import os
from pathlib import Path


def _parse_env_line(line: str) -> tuple[str, str] | None:
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if line.startswith("export "):
        line = line[len("export "):]
    if "=" not in line:
        return None
    key, _, value = line.partition("=")
    key = key.strip()
    value = value.strip()
    if len(value) >= 2 and value[0] == value[-1] and value[0] in ("'", '"'):
        value = value[1:-1]
    if not key:
        return None
    return key, value


def load_dotenv(path: str | os.PathLike | None = None) -> bool:
    """Load KEY=VALUE pairs from a .env file into os.environ.

    Existing environment variables win (same semantics as python-dotenv's
    default ``override=False``). Returns True if a file was found.
    """
    candidates: list[Path] = []
    if path is not None:
        candidates.append(Path(path))
    else:
        cwd = Path.cwd()
        candidates.extend(parent / ".env" for parent in [cwd, *cwd.parents])

    for candidate in candidates:
        try:
            if not candidate.is_file():
                continue
            text = candidate.read_text()
        except OSError:
            continue
        for line in text.splitlines():
            parsed = _parse_env_line(line)
            if parsed is None:
                continue
            key, value = parsed
            os.environ.setdefault(key, value)
        return True
    return False
