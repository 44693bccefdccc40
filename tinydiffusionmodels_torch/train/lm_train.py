"""Base-LM (TinyGPT) training for guided sampling (port of
``train/lm_train.py``).

Standard next-token cross-entropy with AdamW (weight decay 0.01), over
(N, seq_len + 1) token chunks in ``data.loader.batch_iterator``'s order. As
in ``train/text_train.py``, the chunks live on the device and each step
gathers its batch there; the loss is read on the host only at the end of an
epoch.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from tinydiffusionmodels_torch import runtime
from tinydiffusionmodels_torch.core import rng
from tinydiffusionmodels_torch.data.loader import batch_iterator
from tinydiffusionmodels_torch.models.ar_lm import TinyGPT, TinyGPTConfig
from tinydiffusionmodels_torch.train.optim import adamw


def lm_loss(model: TinyGPT, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, L + 1) ids."""
    logits = model(tokens[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           tokens[:, 1:].reshape(-1))


def lm_train_step(model: TinyGPT, optimizer: torch.optim.Optimizer,
                  tokens: torch.Tensor) -> torch.Tensor:
    """One AdamW step (``make_lm_train_step``); returns the loss on the
    device."""
    loss = lm_loss(model, tokens)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_lm(
    chunks: np.ndarray,
    cfg: TinyGPTConfig,
    *,
    epochs: int = 3,
    batch_size: int = 64,
    lr: float = 3e-4,
    seed: int = 0,
    device: torch.device | str | None = None,
    log_fn=print,
) -> TinyGPT:
    """Train a TinyGPT, initialized from ``seed``, on (N, seq_len) token
    chunks; returns the trained module on ``device`` (default
    ``runtime.device()``: the card unless ``TDM_PLATFORM=cpu``)."""
    if chunks.shape[0] == 0:
        raise ValueError("empty corpus: no chunks to train the base LM on")
    if device is None:
        device = runtime.device()
    batch_size = max(1, min(batch_size, chunks.shape[0]))
    # init_tiny_gpt's weights from substream(PRNGKey(seed), "lm_init"), as
    # the JAX trainer draws them, on the device.
    model = TinyGPT(cfg, key=rng.substream(rng.prng_key(seed), "lm_init"),
                    device=device)
    model.train()
    optimizer = adamw(model.parameters(), lr, weight_decay=0.01)
    data = torch.as_tensor(chunks, dtype=torch.long, device=device)
    for epoch in range(epochs):
        order = list(batch_iterator(np.arange(chunks.shape[0]), batch_size,
                                    seed=seed, epoch=epoch))
        t0 = time.perf_counter()
        loss = torch.zeros(())
        if order:
            order_dev = torch.as_tensor(np.stack(order), device=device)
        for i in range(len(order)):
            loss = lm_train_step(model, optimizer, data[order_dev[i]])
        loss = float(loss)
        log_fn(
            f"[lm] epoch {epoch + 1}/{epochs}: {len(order)} steps, "
            f"{len(order) / (time.perf_counter() - t0):.1f} it/s, "
            f"loss={loss:.4f}"
        )
    return model.eval()
