"""Corpus chunking and device-feeding batch iterators.

The port's own copy of ``tinydiffusionmodels_tpu/data/loader.py``: the same
split and the same batch order for the same seed and epoch.

TPU-native data path: the whole dataset lives as one numpy array on host;
each epoch draws a fresh deterministic permutation and yields fixed-shape
batches (static shapes keep XLA from recompiling; the remainder batch is
dropped, matching DataLoader(drop_last=False) only in the reference's
*chunking* step — the reference also drops the corpus remainder,
src/shakespeare.py:146-148).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def tokenize_corpus(
    text: str,
    tokenizer,
    seq_len: int,
    val_split: float = 0.1,
    *,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize once, chunk to (N, seq_len), random train/val split.

    Mirrors reference src/shakespeare.py:128-156 (random_split of chunks).
    """
    ids = tokenizer.encode(text)
    n_chunks = len(ids) // seq_len
    chunks = ids[: n_chunks * seq_len].reshape(n_chunks, seq_len)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_chunks)
    n_val = int(n_chunks * val_split)
    val_idx, train_idx = perm[:n_val], perm[n_val:]
    return chunks[train_idx], chunks[val_idx]


def batch_iterator(
    data: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Yield fixed-shape batches; deterministic per (seed, epoch)."""
    n = data.shape[0]
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.uint64(seed) + np.uint64(epoch) * 1_000_003)
        rng.shuffle(idx)
    limit = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, limit, batch_size):
        yield data[idx[start : start + batch_size]]


def num_batches(n: int, batch_size: int, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)
