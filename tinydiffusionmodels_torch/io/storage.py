"""Transparent local/GCS artifact and checkpoint storage.

The port's own copy of ``tinydiffusionmodels_tpu/io/storage.py`` (parity
surface with reference src/utils.py:11-141). The JAX package writes ``.pth``
files through its dependency-free torch-pickle codec; the port has real torch
and uses ``torch.save`` / ``torch.load`` for the same format, the torch
zipfile serialization of containers of tensors. Loaded tensors come back as
numpy arrays, as the JAX package's loader returns them, so both packages
read one checkpoint into the same containers (``tests/test_torch_package.py``
checks the format both ways). The GCS client import is lazy.

Behavioral contracts preserved:
- gs:// paths are staged through a NamedTemporaryFile and always unlinked
  (src/utils.py:47-83).
- GCS failures are wrapped in RuntimeError with the same message shape
  (src/utils.py:58-59,77-78).
- ``get_samples_dir`` returns a *str* for gs:// (Path would mangle the
  double slash) and a Path otherwise (src/utils.py:127-141).
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Union

import numpy as np
import torch

PathLike = Union[str, Path]


def _with_retries(fn, what: str):
    """Run a GCS transfer with exponential-backoff retries:
    ``TDM_GCS_RETRIES`` (default 3) attempts, 0.5s * 2^k backoff."""
    attempts = max(1, int(os.environ.get("TDM_GCS_RETRIES", "3")))
    for k in range(attempts):
        try:
            return fn()
        except Exception as e:
            if k == attempts - 1:
                raise
            delay = 0.5 * (2 ** k)
            print(f"[storage] {what} failed ({e}); retry {k + 1}/"
                  f"{attempts - 1} in {delay:.1f}s")
            time.sleep(delay)


def is_gcs_path(path: PathLike) -> bool:
    """Check if path is a Google Cloud Storage path (src/utils.py:11-13)."""
    return str(path).startswith("gs://")


def parse_gcs_path(gcs_path: str) -> tuple[str, str]:
    """Split gs://bucket/blob into (bucket, blob) (src/utils.py:16-24)."""
    if not str(gcs_path).startswith("gs://"):
        raise ValueError(f"Not a GCS path: {gcs_path}")
    path_parts = str(gcs_path)[5:].split("/", 1)
    bucket_name = path_parts[0]
    blob_name = path_parts[1] if len(path_parts) > 1 else ""
    return bucket_name, blob_name


def _gcs_client():
    from google.cloud import storage  # lazy: only needed for gs:// paths

    return storage.Client()


def download_from_gcs(gcs_path: str, local_path: str) -> None:
    """Download a GCS object to a local file (src/utils.py:27-33)."""
    bucket_name, blob_name = parse_gcs_path(gcs_path)

    def transfer():
        client = _gcs_client()
        client.bucket(bucket_name).blob(blob_name).download_to_filename(
            local_path
        )

    _with_retries(transfer, f"download {gcs_path}")


def upload_to_gcs(local_path: str, gcs_path: str) -> None:
    """Upload a local file to GCS (src/utils.py:36-42)."""
    bucket_name, blob_name = parse_gcs_path(gcs_path)

    def transfer():
        client = _gcs_client()
        client.bucket(bucket_name).blob(blob_name).upload_from_filename(
            local_path
        )

    _with_retries(transfer, f"upload {gcs_path}")


def _staged(suffix: str, action: str, fn):
    """Run ``fn(tmp_path)`` against a staging tempfile for a gs:// transfer;
    failures become ``RuntimeError("Failed to <action>: <err>")`` and the
    staging file is always unlinked."""
    tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    tmp.close()
    try:
        return fn(tmp.name)
    except Exception as e:
        raise RuntimeError(f"Failed to {action}: {e}")
    finally:
        os.unlink(tmp.name)


def _to_tensors(obj: Any) -> Any:
    """numpy leaves -> CPU tensors (what torch.save writes as tensors)."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, OrderedDict):
        return OrderedDict((k, _to_tensors(v)) for k, v in obj.items())
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v) for v in obj)
    return obj


def _to_numpy(obj: Any) -> Any:
    """Tensor leaves -> numpy arrays; bfloat16, which numpy lacks, is
    widened to float32."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            obj = obj.float()
        return obj.numpy()
    if isinstance(obj, OrderedDict):
        return OrderedDict((k, _to_numpy(v)) for k, v in obj.items())
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _torch_load(path: str) -> Any:
    # weights_only: containers of tensors and plain values, no code.
    return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))


def load_checkpoint(ckpt_path: PathLike, device: str | None = None) -> Any:
    """Load a .pth checkpoint from local disk or GCS (src/utils.py:47-63).

    Returns numpy-leafed containers. ``device`` is accepted for signature
    parity; the caller moves tensors where it needs them.
    """
    ckpt_path = str(ckpt_path)
    if not is_gcs_path(ckpt_path):
        return _torch_load(ckpt_path)

    def fetch(tmp_name):
        print(f"Downloading checkpoint from GCS: {ckpt_path}")
        download_from_gcs(ckpt_path, tmp_name)
        return _torch_load(tmp_name)

    return _staged(".pth", f"download checkpoint from {ckpt_path}", fetch)


def save_checkpoint(model_state: Any, ckpt_path: PathLike) -> None:
    """Save a checkpoint to local disk or GCS (src/utils.py:66-83)."""
    ckpt_path = str(ckpt_path)
    if not is_gcs_path(ckpt_path):
        # Atomic local write: stage + os.replace, so a killed process never
        # leaves a truncated checkpoint behind.
        tmp_path = f"{ckpt_path}.tmp"
        torch.save(_to_tensors(model_state), tmp_path)
        os.replace(tmp_path, ckpt_path)
        print(f"✔ Saved checkpoint to {ckpt_path}")
        return

    def push(tmp_name):
        torch.save(_to_tensors(model_state), tmp_name)
        print(f"Uploading checkpoint to GCS: {ckpt_path}")
        upload_to_gcs(tmp_name, ckpt_path)
        print(f"✔ Uploaded checkpoint to {ckpt_path}")

    _staged(".pth", f"upload checkpoint to {ckpt_path}", push)


def save_samples(content: Union[str, bytes], sample_path: PathLike,
                 mode: str = "w") -> None:
    """Write a text/binary sample artifact locally or to GCS
    (src/utils.py:86-117)."""
    sample_path = str(sample_path)
    if not is_gcs_path(sample_path):
        Path(sample_path).parent.mkdir(parents=True, exist_ok=True)
        if isinstance(content, str):
            Path(sample_path).write_text(content)
        else:
            Path(sample_path).write_bytes(content)
        print(f"✔ Saved sample to {sample_path}")
        return

    def push(tmp_name):
        with open(tmp_name, mode) as f:
            f.write(content)
        print(f"Uploading sample to GCS: {sample_path}")
        upload_to_gcs(tmp_name, sample_path)
        print(f"✔ Uploaded sample to {sample_path}")

    _staged(Path(sample_path).suffix, f"upload sample to {sample_path}", push)


def get_vertex_checkpoint_path(base_name: str) -> str:
    """AIP_MODEL_DIR-aware checkpoint path (src/utils.py:120-124)."""
    if "AIP_MODEL_DIR" in os.environ:
        return os.path.join(os.environ["AIP_MODEL_DIR"], base_name)
    return base_name


def get_samples_dir(base_dir: str = "samples") -> Union[str, Path]:
    """Samples directory; str for gs:// to avoid Path normalization
    (src/utils.py:127-141)."""
    if "AIP_MODEL_DIR" in os.environ:
        model_dir = os.environ["AIP_MODEL_DIR"]
        if model_dir.startswith("gs://"):
            clean_model_dir = model_dir.rstrip("/")
            clean_base_dir = base_dir.strip("/")
            return f"{clean_model_dir}/{clean_base_dir}"
        return Path(model_dir) / base_dir
    return Path(base_dir)
