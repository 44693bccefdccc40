"""The JAX package's initialisers on its key tree (port of
``models/torch_init.py``'s ``linear_params``, ``conv_params``,
``xavier_uniform`` and ``layernorm_params``, and of each model's
``init_*``).

Each ``init_*`` function takes the JAX function's key (a (2,) key, or a
``core.rng.KeyPath`` on the device) and splits it as the JAX function
does, key for key, so one seed gives the JAX package's initial weights:
the uniform draws bit for bit, ``0.02 * normal`` within the normals' 3
ulp. It returns the JAX parameter tree ((in, out) linears, HWIO kernels,
fused (d, 3d) qkv) with tensors on ``device``: every draw of the model in
one ``ops.rng.draw_many`` call, so one kernel launch on the card and the
plain ``core/rng.py`` draws on the CPU. ``io.convert``'s
``*_state_from_jax`` turn a tree into the module's state dict (the
transposes to (out, in) and OIHW), which the modules load.
"""

from __future__ import annotations

import numpy as np
import torch

from tinydiffusionmodels_torch import ops
from tinydiffusionmodels_torch.core import rng


def default_key(key):
    """``key``, or ``PRNGKey(0)`` when None."""
    return rng.prng_key(0) if key is None else key


def _uniform(key, shape, bound) -> ops.rng.Draw:
    return ops.rng.Draw("uniform", key, tuple(shape), minval=-float(bound),
                        maxval=float(bound))


def linear_params(key, in_dim: int, out_dim: int, *,
                  bias: bool = True) -> dict:
    """torch nn.Linear's default init, w (in, out) and b (out,):
    U(+-1/sqrt(in_dim)) under ``split(key)``."""
    kw, kb = rng.split(key)
    bound = 1.0 / np.sqrt(in_dim)
    p = {"w": _uniform(kw, (in_dim, out_dim), bound)}
    if bias:
        p["b"] = _uniform(kb, (out_dim,), bound)
    return p


def conv_params(key, kh: int, kw_: int, in_ch: int, out_ch: int) -> dict:
    """torch nn.Conv2d's default init, the kernel HWIO."""
    k1, k2 = rng.split(key)
    bound = 1.0 / np.sqrt(in_ch * kh * kw_)
    return {"w": _uniform(k1, (kh, kw_, in_ch, out_ch), bound),
            "b": _uniform(k2, (out_ch,), bound)}


def xavier_uniform(key, shape, fan_in: int, fan_out: int) -> ops.rng.Draw:
    return _uniform(key, shape, np.sqrt(6.0 / (fan_in + fan_out)))


def _normal(key, shape, scale: float) -> ops.rng.Draw:
    """``scale * jax.random.normal(key, shape)``."""
    return ops.rng.Draw("normal", key, tuple(shape), scale=scale)


def layernorm_params(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif isinstance(tree, ops.rng.Draw):
        out.append(tree)


def _fill(tree, drawn, device):
    if isinstance(tree, dict):
        return {k: _fill(v, drawn, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, drawn, device) for v in tree)
    if isinstance(tree, ops.rng.Draw):
        return next(drawn)
    if torch.is_tensor(tree):
        return tree.to(device)
    return tree


def materialize(tree, device="cpu"):
    """The tree with every ``Draw`` made on ``device`` in one
    ``draw_many`` call and every tensor moved there."""
    device = torch.device(device)
    draws: list = []
    _leaves(tree, draws)
    return _fill(tree, iter(ops.rng.draw_many(draws, device)), device)


def init_tiny_transformer(key, cfg, device="cpu") -> dict:
    """``init_tiny_transformer``: ``split(key, depth + 1)``, the time
    bias from the first key, the layers from the rest (``split(k, 6)``
    each: xavier in_proj, the out projection's weight, linear1, linear2),
    the position table ``0.02 * normal(fold_in(keys[0], 1))`` and a zero
    self-conditioning projection."""
    d = cfg.dim
    keys = rng.split(key, cfg.depth + 1)
    layers = []
    for k in keys[1:]:
        k = rng.split(k, 6)
        layers.append({
            "self_attn": {
                "in_proj": {"w": xavier_uniform(k[0], (d, 3 * d), d, 3 * d),
                            "b": torch.zeros(3 * d)},
                "out_proj": {"w": linear_params(k[1], d, d)["w"],
                             "b": torch.zeros(d)},
            },
            "linear1": linear_params(k[2], d, cfg.ffn_dim),
            "linear2": linear_params(k[3], cfg.ffn_dim, d),
            "norm1": layernorm_params(d),
            "norm2": layernorm_params(d),
        })
    params = {"time_emb": linear_params(keys[0], 1, d),
              "layers": tuple(layers)}
    if cfg.pos_kind == "abs":
        params["pos_emb"] = _normal(rng.fold_in(keys[0], 1),
                                    (cfg.max_len, d), 0.02)
    if cfg.self_cond:
        params["selfcond_proj"] = {"w": torch.zeros(d, d),
                                   "b": torch.zeros(d)}
    return materialize(params, device)


def init_learned_embedding(key, vocab_size: int, embed_dim: int,
                           pretrained=None, device="cpu") -> dict:
    """``init_learned_embedding``: a (vocab, dim) table of ``0.02 *
    normal(key)``, or ``pretrained`` (vocab, pre_dim), projected through
    ``linear_params(key, pre_dim, dim, bias=False)['w']`` when pre_dim !=
    dim (the reference's untrained projection)."""
    if pretrained is None:
        return materialize(
            {"weight": _normal(key, (vocab_size, embed_dim), 0.02)}, device)
    pre = torch.as_tensor(np.asarray(pretrained, dtype=np.float32),
                          device=device)
    if pre.shape[0] != vocab_size:
        raise ValueError(f"pretrained vocab {pre.shape[0]} != {vocab_size}")
    if pre.shape[1] == embed_dim:
        return {"weight": pre}
    proj = materialize(linear_params(key, pre.shape[1], embed_dim,
                                     bias=False), device)["w"]
    return {"weight": pre @ proj}


def init_learned_rounding(key, embed_dim: int, vocab_size: int,
                          device="cpu") -> dict:
    """``init_learned_rounding``: {'decoder': Linear(dim, vocab)}."""
    return materialize({"decoder": linear_params(key, embed_dim,
                                                 vocab_size)}, device)


# (in_ch, out_ch) per residual block, reference src/mnist.py:68-74.
UNET_BLOCKS = {"rb1": (1, 32), "rb2": (32, 64), "rb3": (64, 64),
               "rb4": (96, 32)}


def init_unet(key, device="cpu") -> dict:
    """``init_unet``: ``split(key, 5)``, a block from each of the first
    four (``split(k, 4)``: conv1, conv2, time_emb, skip; no skip where
    the channels stay), the 1x1 output conv from the last."""
    keys = rng.split(key, len(UNET_BLOCKS) + 1)
    params = {}
    for k, (name, (cin, cout)) in zip(keys, UNET_BLOCKS.items()):
        k1, k2, k3, k4 = rng.split(k, 4)
        params[name] = {
            "conv1": conv_params(k1, 3, 3, cin, cout),
            "conv2": conv_params(k2, 3, 3, cout, cout),
            "time_emb": linear_params(k3, 1, cout),
            "skip": conv_params(k4, 1, 1, cin, cout) if cin != cout
            else None,
        }
    params["out"] = conv_params(keys[-1], 1, 1, 32, 1)
    return materialize(params, device)


def init_tiny_gpt(key, cfg, device="cpu") -> dict:
    """``init_tiny_gpt``: ``split(key, depth + 3)``: the token table
    ``0.02 * normal``, the position table ``0.01 * normal``, a block from
    each middle key (``split(k, 4)``: qkv, proj, fc, proj), the bias-free
    LM head from the last."""
    keys = rng.split(key, cfg.depth + 3)
    d = cfg.dim
    blocks = []
    for k in keys[2:-1]:
        k = rng.split(k, 4)
        blocks.append({
            "ln1": layernorm_params(d),
            "attn": {"qkv": linear_params(k[0], d, 3 * d),
                     "proj": linear_params(k[1], d, d)},
            "ln2": layernorm_params(d),
            "mlp": {"fc": linear_params(k[2], d, cfg.ffn_mult * d),
                    "proj": linear_params(k[3], cfg.ffn_mult * d, d)},
        })
    params = {
        "tok_emb": _normal(keys[0], (cfg.vocab_size, d), 0.02),
        "pos_emb": _normal(keys[1], (cfg.max_len, d), 0.01),
        "blocks": tuple(blocks),
        "ln_f": layernorm_params(d),
        "lm_head": linear_params(keys[-1], d, cfg.vocab_size, bias=False),
    }
    return materialize(params, device)


def init_classifier(key, n_classes: int = 10, device="cpu") -> dict:
    """``init_classifier``: ``split(key, 4)``: conv 1 -> 16, conv 16 ->
    32, fc 1568 -> 128, fc 128 -> n_classes."""
    k = rng.split(key, 4)
    return materialize({
        "conv1": conv_params(k[0], 3, 3, 1, 16),
        "conv2": conv_params(k[1], 3, 3, 16, 32),
        "fc1": linear_params(k[2], 7 * 7 * 32, 128),
        "fc2": linear_params(k[3], 128, n_classes),
    }, device)
