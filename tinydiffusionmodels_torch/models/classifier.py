"""The small CNN digit classifier that measures MNIST sample fidelity (port
of ``models/classifier.py``).

conv 1 -> 16 and 16 -> 32 (3x3, same padding), each followed by ReLU and a
2x2 max-pool, then fc 1568 -> 128 (ReLU; the 128-d features are the FID
space) and fc 128 -> 10. Inputs are NHWC (B, 28, 28, 1) in [-1, 1], as the
UNet's samples are. The feature map is flattened in the module's NCHW
(CHW) order, where the JAX package flattens NHWC (HWC); the weight bridge
(``io.convert.classifier_state_from_jax``) permutes ``fc1``'s input rows
to match. Plain PyTorch convolutions and matmuls: the JAX classifier runs
no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusionmodels_torch.io import convert
from tinydiffusionmodels_torch.models import init
from tinydiffusionmodels_torch.models.unet import _conv


class DigitClassifier(nn.Module):
    """``init_classifier``'s network, its weights drawn from ``key``
    (``PRNGKey(0)`` when None) on ``device``."""

    def __init__(self, n_classes: int = 10, *, key=None, device=None):
        super().__init__()
        self.conv1 = _conv(1, 16, 3)
        self.conv2 = _conv(16, 32, 3)
        self.fc1 = nn.utils.skip_init(nn.Linear, 7 * 7 * 32, 128)
        self.fc2 = nn.utils.skip_init(nn.Linear, 128, n_classes)
        self.to(device)
        # nn.utils.skip_init builds a module to load into: no draw.
        if self.fc1.weight.is_meta:
            return
        self.load_state_dict(convert.classifier_state_from_jax(
            init.init_classifier(init.default_key(key), n_classes,
                                 self.fc1.weight.device)))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 28, 28, 1) -> the penultimate features (B, 128)."""
        h = x.permute(0, 3, 1, 2)
        h = F.max_pool2d(F.relu(self.conv1(h)), 2)       # (B, 16, 14, 14)
        h = F.max_pool2d(F.relu(self.conv2(h)), 2)       # (B, 32, 7, 7)
        return F.relu(self.fc1(h.flatten(1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 28, 28, 1) -> logits (B, 10)."""
        return self.fc2(self.features(x))


def classifier_features(model: DigitClassifier,
                        x: torch.Tensor) -> torch.Tensor:
    """``classifier_features``: x (B, 28, 28, 1) in [-1, 1] -> (B, 128)."""
    return model.features(x)


def classifier_apply(model: DigitClassifier, x: torch.Tensor) -> torch.Tensor:
    """``classifier_apply``: x (B, 28, 28, 1) in [-1, 1] -> logits (B, 10)."""
    return model(x)
