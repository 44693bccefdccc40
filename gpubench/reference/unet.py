"""The reference's SimpleUNet (src/mnist.py:45-87), plainly.

rb1 (1 -> 32) at 28 x 28, a 2 x 2 mean pool, rb2 (32 -> 64) and rb3
(64 -> 64) at 14 x 14, nearest upsampling x 2, the concatenation with
rb1's output (96 channels), rb4 (96 -> 32), a 1 x 1 convolution to one
channel. A residual block is relu(conv3x3(x)) + Linear(1, C)(t / T), then
relu(conv3x3(.)) plus the input, through a 1 x 1 convolution where the
channel count changes. Images are NHWC at the edges, as the program's
are; parameters are a dict under the program's state-dict names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCKS = {"rb1": (1, 32), "rb2": (32, 64), "rb3": (64, 64), "rb4": (96, 32)}


def _block(p, name, x, t_scaled):
    """x (B, C, H, W) -> (B, Cout, H, W)."""
    h = F.relu(F.conv2d(x, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"],
                        padding=1))
    tb = F.linear(t_scaled, p[f"{name}.time_emb.weight"],
                  p[f"{name}.time_emb.bias"])
    h = h + tb[:, :, None, None]
    h = F.relu(F.conv2d(h, p[f"{name}.conv2.weight"], p[f"{name}.conv2.bias"],
                        padding=1))
    if f"{name}.skip.weight" in p:
        x = F.conv2d(x, p[f"{name}.skip.weight"], p[f"{name}.skip.bias"])
    return h + x


def denoise(p: dict, x, t, *, timesteps: int):
    """eps_hat of NHWC images ``x`` (B, 28, 28, 1) at (B,) timesteps."""
    t_scaled = (t.to(x.dtype) / timesteps)[:, None]
    x = x.permute(0, 3, 1, 2)
    h1 = _block(p, "rb1", x, t_scaled)
    h2 = _block(p, "rb2", F.avg_pool2d(h1, 2), t_scaled)
    h3 = _block(p, "rb3", h2, t_scaled)
    up = h3.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    h4 = _block(p, "rb4", torch.cat([up, h1], dim=1), t_scaled)
    out = F.conv2d(h4, p["out.weight"], p["out.bias"])
    return out.permute(0, 2, 3, 1)
