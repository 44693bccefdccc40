"""The text denoiser, its rounding head and its training loss, plainly.

The reference's TinyTransformer (src/shakespeare.py): a time bias
Linear(1, dim) of t / T added to the noisy embeddings, then post-LN
encoder layers (fused QKV projection, softmax attention, output
projection, ReLU feed-forward), no positions. Dropout at the program's
sites and with its masks, drawn again from the key tree: the input,
the attention weights (the flash kernels' coordinate hash, seeded per
layer), after the attention block, after the ReLU and after the second
linear. The rounding head is one Linear(dim, vocab). The loss is the
eps-prediction MSE plus the rounding head's cross-entropy on the clean
embeddings of the tokens, the table frozen.

Parameters are a dict of float32 tensors under the program's state-dict
names (``encoder.layers.0.linear1.weight``, ``decoder.weight``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference import keytree
from gpubench.reference.diffusion import Schedule, q_sample

KEEP = 0.9          # 1 - the dropout rate of every site


def _drop(x: torch.Tensor, key, rate: float) -> torch.Tensor:
    if key is None:
        return x
    keep = keytree.counter_keep(key, keytree.full_index(x.shape, x.device),
                                1.0 - rate)
    div = float(torch.tensor(1.0 - rate, dtype=torch.float32))
    return torch.where(keep, x / div, torch.zeros((), device=x.device))


def _attention(p, pre, x, heads, seed, rate):
    b, n, d = x.shape
    dh = d // heads
    qkv = F.linear(x, p[pre + "in_proj_weight"], p[pre + "in_proj_bias"])
    q, k, v = (a.reshape(b, n, heads, dh).transpose(1, 2)
               for a in qkv.split(d, dim=-1))
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    if seed is not None:
        dev = x.device
        bh = (torch.arange(b, device=dev)[:, None] * heads
              + torch.arange(heads, device=dev)[None, :])[..., None, None]
        pos = torch.arange(n, device=dev)
        w = w * keytree.attention_keep_scale(seed, bh, pos[:, None],
                                             pos[None, :], rate)
    out = (w @ v).transpose(1, 2).reshape(b, n, d)
    return F.linear(out, p[pre + "out_proj.weight"], p[pre + "out_proj.bias"])


def denoise(p: dict, x, t, *, heads: int, depth: int, timesteps: int,
            rate: float = 0.0, dropout_key=None):
    """eps_hat of (B, L, dim) ``x`` at (B,) timesteps ``t``; with
    ``dropout_key`` (training) every dropout mask is drawn from it."""
    dk = dropout_key
    x = x + F.linear((t.to(x.dtype) / timesteps)[:, None],
                     p["time_emb.weight"], p["time_emb.bias"])[:, None, :]
    if dk is not None:
        x = _drop(x, keytree.substream(dk, "input_dropout"), rate)
    for i in range(depth):
        pre = f"encoder.layers.{i}."
        ki = None if dk is None else keytree.fold_in(dk, i)
        seed = None
        if ki is not None:
            seed = int(keytree.randint32(
                keytree.substream(ki, "attn_weights"),
                torch.zeros(1, dtype=torch.int64), -2**31, 2**31 - 1)[0])

        def site(y, name):
            return y if ki is None else _drop(
                y, keytree.substream(ki, name), rate)

        d = x.shape[-1]
        sa = site(_attention(p, pre + "self_attn.", x, heads, seed, rate),
                  "dropout1")
        x = F.layer_norm(x + sa, (d,), p[pre + "norm1.weight"],
                         p[pre + "norm1.bias"], 1e-5)
        ff = site(F.relu(F.linear(x, p[pre + "linear1.weight"],
                                  p[pre + "linear1.bias"])), "dropout_ffn")
        ff = site(F.linear(ff, p[pre + "linear2.weight"],
                           p[pre + "linear2.bias"]), "dropout2")
        x = F.layer_norm(x + ff, (d,), p[pre + "norm2.weight"],
                         p[pre + "norm2.bias"], 1e-5)
    return x


def rounding_logits(p: dict, x):
    return F.linear(x, p["decoder.weight"], p["decoder.bias"])


def step_draws(step_key, batch: int, length: int, dim: int, timesteps: int,
               device):
    """A training step's timesteps (B,), noise (B, L, dim) and dropout
    key, drawn from the step's key."""
    t = keytree.randint32(keytree.substream(step_key, "timesteps"),
                          torch.arange(batch, device=device), 0, timesteps)
    shape = (batch, length, dim)
    noise = keytree.counter_normal(keytree.substream(step_key, "noise"),
                                   keytree.full_index(shape, device),
                                   math.prod(shape))
    return t, noise, keytree.substream(step_key, "dropout")


def train_losses(den: dict, rnd: dict, table, tokens, step_key, *, sched:
                 Schedule, heads: int, depth: int, rate: float,
                 rounding_weight: float):
    """(diffusion MSE, rounding CE, total) of one training step."""
    b, n = tokens.shape
    x0 = table[tokens]
    t, noise, dk = step_draws(step_key, b, n, x0.shape[-1], sched.timesteps,
                              x0.device)
    pred = denoise(den, q_sample(sched, x0, t, noise), t, heads=heads,
                   depth=depth, timesteps=sched.timesteps, rate=rate,
                   dropout_key=dk)
    diff = torch.mean(torch.square(pred - noise))
    logp = F.log_softmax(rounding_logits(rnd, x0), dim=-1)
    ce = -torch.gather(logp, -1, tokens[..., None]).mean()
    return diff, ce, diff + rounding_weight * ce
