"""SimpleUNet: the 4-block eps-prediction UNet of the MNIST DDPM (port of
``models/unet.py``).

The reference's topology (src/mnist.py:45-87): channel plan 1 -> 32 ->
pool/2 -> 32 -> 64 -> 64 -> nearest-up x2 -> concat skip (96 channels) ->
32 -> 1x1 conv -> 1, with the time t/T through a Linear(1, C) per block as a
per-channel bias. Activations stay NHWC, as in the JAX package, so the
sampler's shape is (n, 28, 28, 1) in both. Each residual block is one
``ops.fused_resblock`` call, rb4 one ``ops.fused_resblock_split`` (one
kernel launch each on the card). Submodule
names are the reference's (``rb1..rb4.{conv1,conv2,time_emb,skip}``,
``out``), so a ``.pth`` either package wrote loads with
``load_state_dict(strict=True)``.

The decoder block rb4 is the JAX package's concat-free split decoder
(``_split_decoder``): ``ops.fused_resblock_split(h3, h1, upsample_a=2)``,
whose kernel reads h3 at half resolution and h1 where it would read
cat(upsample(h3), h1), so on the card no upsampled or concatenated tensor
is built (on the CPU its plain version builds them, as before). It runs on
every batch and reads no ``TDM_SPLIT_DECODER``: the JAX package's knob and
its batch >= 1024 threshold weighed XLA's extra conv calls against the
concat's data movement on a v5e, and here the split costs no extra launch.
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

    def forward(self, x: torch.Tensor, t_scaled: torch.Tensor,
                x_b: torch.Tensor | None = None, *,
                upsample_a: int = 1) -> torch.Tensor:
        """x (B, H, W, Cin) NHWC, t_scaled (B, 1) -> (B, H, W, Cout). With
        ``x_b`` the block's input is cat(upsample(x, upsample_a), x_b)
        along channels (``ops.fused_resblock_split``)."""
        time_bias = self.time_emb(t_scaled)[:, None, None, :]
        skip = (None, None) if self.skip is None else (
            self.skip.weight, self.skip.bias)
        params = (self.conv1.weight, self.conv1.bias, self.conv2.weight,
                  self.conv2.bias, time_bias, *skip)
        if x_b is None:
            return ops.fused_resblock(x, *params)
        return ops.fused_resblock_split(x, x_b, *params,
                                        upsample_a=upsample_a)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 mean pool over NHWC (even H, W: 28 -> 14)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


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
        # rb4 on cat(upsample(h3), h1) (B,H,W,96), gathered by the kernel
        h4 = self.rb4(h3, t_scaled, h1, upsample_a=2)            # (B,H,W,32)
        # The 1x1 output conv is a matmul over channels, as the JAX package
        # leaves it to XLA outside any kernel.
        return F.linear(h4, self.out.weight.flatten(1), self.out.bias)
