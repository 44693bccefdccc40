"""SimpleUNet: the 4-block eps-prediction UNet of the MNIST DDPM (port of
``models/unet.py``).

The reference's topology (src/mnist.py:45-87): channel plan 1 -> 32 ->
pool/2 -> 32 -> 64 -> 64 -> nearest-up x2 -> concat skip (96 channels) ->
32 -> 1x1 conv -> 1, with the time t/T through a Linear(1, C) per block as a
per-channel bias. Activations stay NHWC, as in the JAX package, so the
sampler's shape is (n, 28, 28, 1) in both. Each residual block is one
``ops.fused_resblock`` call (one kernel launch on the card). Submodule
names are the reference's (``rb1..rb4.{conv1,conv2,time_emb,skip}``,
``out``), so a ``.pth`` either package wrote loads with
``load_state_dict(strict=True)``.

Not carried over: the concat-free split decoder (``_split_decoder``,
``TDM_SPLIT_DECODER``), a TPU measurement; rb4 always concatenates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusionmodels_torch import ops
from tinydiffusionmodels_torch.io import convert
from tinydiffusionmodels_torch.models import init

BLOCKS = init.UNET_BLOCKS


def _conv(in_ch: int, out_ch: int, k: int) -> nn.Conv2d:
    """An nn.Conv2d (same padding) left for the initialiser to fill."""
    return nn.utils.skip_init(nn.Conv2d, in_ch, out_ch, k, padding=k // 2)


class ResBlock(nn.Module):
    """relu(conv1(x)) + time bias -> relu(conv2(.)) + skip(x); the skip is
    a 1x1 conv where the channel count changes, else the identity."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = _conv(in_ch, out_ch, 3)
        self.conv2 = _conv(out_ch, out_ch, 3)
        self.time_emb = nn.utils.skip_init(nn.Linear, 1, out_ch)
        self.skip = _conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, t_scaled: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, Cin) NHWC, t_scaled (B, 1) -> (B, H, W, Cout)."""
        time_bias = self.time_emb(t_scaled)[:, None, None, :]
        skip = (None, None) if self.skip is None else (
            self.skip.weight, self.skip.bias)
        return ops.fused_resblock(
            x, self.conv1.weight, self.conv1.bias, self.conv2.weight,
            self.conv2.bias, time_bias, *skip)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 mean pool over NHWC (even H, W: 28 -> 14)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class SimpleUNet(nn.Module):
    """The MNIST denoiser: (x_t (B, H, W, 1) NHWC, t (B,) int) -> eps_hat.
    The weights are ``init_unet``'s from ``key`` (``PRNGKey(0)`` when
    None), drawn on ``device``: torch's nn.Conv2d and nn.Linear defaults,
    U(+-1/sqrt(fan_in))."""

    def __init__(self, timesteps: int = 1000, *, key=None, device=None):
        super().__init__()
        self.timesteps = timesteps
        for name, (cin, cout) in BLOCKS.items():
            self.add_module(name, ResBlock(cin, cout))
        self.out = _conv(32, 1, 1)
        self.to(device)
        # nn.utils.skip_init builds a module to load into: no draw.
        if self.out.weight.is_meta:
            return
        self.load_state_dict(convert.unet_state_from_jax(init.init_unet(
            init.default_key(key), self.out.weight.device)))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Mirrors ``unet_apply`` (reference src/mnist.py:76-87)."""
        t_scaled = (t.to(x.dtype) / self.timesteps)[:, None]     # (B, 1)
        h1 = self.rb1(x, t_scaled)                               # (B,H,W,32)
        h2 = self.rb2(_avg_pool2(h1), t_scaled)                  # (B,H/2,W/2,64)
        h3 = self.rb3(h2, t_scaled)                              # (B,H/2,W/2,64)
        h4 = torch.cat([_upsample_nearest2(h3), h1], dim=-1)     # (B,H,W,96)
        h4 = self.rb4(h4, t_scaled)                              # (B,H,W,32)
        # The 1x1 output conv is a matmul over channels, as the JAX package
        # leaves it to XLA outside any kernel.
        return F.linear(h4, self.out.weight.flatten(1), self.out.bias)
