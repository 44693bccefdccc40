"""FLOPs of a whole step, from the configuration and the batch: the
products (matrix multiplications, convolutions, the attention products)
the algorithm needs, 2 FLOPs a multiply-add, as
``torch.utils.flop_counter`` counts them on the plain reference (the
tests hold the two equal at a small size). A backward counts a product's
input gradient only where its input needs one and its weight gradient
always; a recomputation is not counted."""

from __future__ import annotations


def _layer_products(n: int, b: int, length: int, dim: int, heads: int,
                    ffn: int) -> int:
    """One encoder layer's forward products over n = b * length rows."""
    dh = dim // heads
    return (2 * n * dim * 3 * dim + 2 * 2 * b * heads * length * length * dh
            + 2 * n * dim * dim + 2 * 2 * n * dim * ffn)


def text_train_step(batch: int, length: int, dim: int, heads: int,
                    depth: int, ffn: int, vocab: int) -> int:
    """A training step of the denoiser and the rounding head: the
    denoiser's products forward and twice backward, its time bias
    Linear(1, dim) forward and weight gradient, and the rounding head's
    forward and weight gradient (the embedding table is frozen, so neither
    its input needs a gradient)."""
    n = batch * length
    den = depth * _layer_products(n, batch, length, dim, heads, ffn)
    return 3 * den + 2 * 2 * batch * dim + 2 * 2 * n * dim * vocab


def text_sample_batch(n: int, length: int, dim: int, heads: int, depth: int,
                      ffn: int, vocab: int, timesteps: int) -> int:
    """A whole sampled batch: ``timesteps`` denoiser forwards, then the
    rounding head's logits once."""
    rows = n * length
    step = depth * _layer_products(rows, n, length, dim, heads, ffn) \
        + 2 * n * dim
    return timesteps * step + 2 * rows * dim * vocab


# (cin, cout, height) of each residual block and whether it has a 1 x 1 skip
_UNET = (("rb1", 1, 32, 28, True), ("rb2", 32, 64, 14, True),
         ("rb3", 64, 64, 14, False), ("rb4", 96, 32, 28, True))


def _unet_products(b: int) -> tuple[int, int]:
    """(forward products of a SimpleUNet at batch b, those of them whose
    input is the image itself: rb1's conv1 and skip)."""
    total = image = 0
    for name, cin, cout, hw, skip in _UNET:
        pix = b * hw * hw
        conv1 = 2 * pix * 9 * cin * cout
        sk = 2 * pix * cin * cout if skip else 0
        total += conv1 + 2 * pix * 9 * cout * cout + sk + 2 * b * cout
        if name == "rb1":
            image = conv1 + sk
    total += 2 * b * 28 * 28 * 32
    return total, image


def unet_train_step(batch: int) -> int:
    """A training step: the forward, every weight gradient, and every input
    gradient but those of the products that read the image (the noisy
    image needs none) and of the time biases (t / T needs none)."""
    fwd, image = _unet_products(batch)
    time = sum(2 * batch * cout for _, _, cout, _, _ in _UNET)
    return 3 * fwd - image - time


def unet_sample_batch(n: int, timesteps: int) -> int:
    return timesteps * _unet_products(n)[0]
