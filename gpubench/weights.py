"""Weights and inputs made by the benchmark from ``--seed``, on the device.

Both sides get the same tensors: the program loads them into its modules,
and the reference, after the window, makes them again from the same seed.
All leaves of a cell come from one ``torch.Generator`` on the device, in
one uniform and one normal draw, then are cut and scaled leaf by leaf:
torch's module defaults (U(+-1/sqrt(fan_in)) for linear and convolution
weights and biases, xavier-uniform for attention's fused projection with
zero biases, LayerNorm 1 and 0).
"""

from __future__ import annotations

import math

import torch

# (name, shape, (kind, value)): kind "uniform" (U(+-value)), "normal"
# (N(0, value^2)) or "fill".
Spec = tuple[str, tuple[int, ...], tuple[str, float]]


def _linear(name: str, fan_out: int, fan_in: int) -> list[Spec]:
    a = 1.0 / math.sqrt(fan_in)
    return [(f"{name}.weight", (fan_out, fan_in), ("uniform", a)),
            (f"{name}.bias", (fan_out,), ("uniform", a))]


def transformer(dim: int, depth: int, ffn: int,
                prefix: str = "") -> list[Spec]:
    """The TinyTransformer denoiser's leaves."""
    specs = _linear(prefix + "time_emb", dim, 1)
    for i in range(depth):
        p = f"{prefix}encoder.layers.{i}."
        specs += [
            (p + "self_attn.in_proj_weight", (3 * dim, dim),
             ("uniform", math.sqrt(6.0 / (4 * dim)))),
            (p + "self_attn.in_proj_bias", (3 * dim,), ("fill", 0.0)),
            (p + "self_attn.out_proj.weight", (dim, dim),
             ("uniform", 1.0 / math.sqrt(dim))),
            (p + "self_attn.out_proj.bias", (dim,), ("fill", 0.0)),
            *_linear(p + "linear1", ffn, dim),
            *_linear(p + "linear2", dim, ffn),
            (p + "norm1.weight", (dim,), ("fill", 1.0)),
            (p + "norm1.bias", (dim,), ("fill", 0.0)),
            (p + "norm2.weight", (dim,), ("fill", 1.0)),
            (p + "norm2.bias", (dim,), ("fill", 0.0)),
        ]
    return specs


def rounding(dim: int, vocab: int, prefix: str = "") -> list[Spec]:
    return _linear(prefix + "decoder", vocab, dim)


def unet(blocks: dict) -> list[Spec]:
    """SimpleUNet's leaves; ``blocks`` maps a block to (cin, cout)."""
    specs: list[Spec] = []
    for name, (cin, cout) in blocks.items():
        for conv, ci, k in (("conv1", cin, 3), ("conv2", cout, 3)):
            a = 1.0 / math.sqrt(ci * k * k)
            specs += [(f"{name}.{conv}.weight", (cout, ci, k, k),
                       ("uniform", a)),
                      (f"{name}.{conv}.bias", (cout,), ("uniform", a))]
        specs += _linear(f"{name}.time_emb", cout, 1)
        if cin != cout:
            a = 1.0 / math.sqrt(cin)
            specs += [(f"{name}.skip.weight", (cout, cin, 1, 1),
                       ("uniform", a)),
                      (f"{name}.skip.bias", (cout,), ("uniform", a))]
    a = 1.0 / math.sqrt(32)
    return specs + [("out.weight", (1, 32, 1, 1), ("uniform", a)),
                    ("out.bias", (1,), ("uniform", a))]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def draw(specs: list[Spec], gen: torch.Generator, device) -> dict:
    """The leaves of ``specs``, float32 on ``device``: one uniform draw for
    the uniform leaves and one normal draw for the normal ones."""
    sizes = {kind: sum(math.prod(s) for _, s, (k, _) in specs if k == kind)
             for kind in ("uniform", "normal")}
    flat = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                  device=device).mul_(2.0).sub_(1.0),
            "normal": torch.randn(sizes["normal"], generator=gen,
                                  device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (kind, value) in specs:
        if kind == "fill":
            out[name] = torch.full(shape, value, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[kind][at[kind]:at[kind] + n].view(shape).mul_(value)
        at[kind] += n
    return out
