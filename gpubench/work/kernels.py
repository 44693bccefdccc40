"""Bytes and FLOPs of one call of the program's hand-written kernels, from
the call's shapes: each input read once and each output written once, 2
FLOPs a multiply-add of the products the kernel's function needs.

A frozen copy of the arithmetic of ``work`` in the program's
``ops/flash_attention.py`` and ``ops/resblock.py`` (the tests hold the two
against each other at small shapes)."""

from __future__ import annotations


def flash(kernel: str, b: int, h: int, lq: int, lk: int, dh: int, dv: int,
          itemsize: int, *, dropout: bool, lse: bool = True
          ) -> tuple[int, int]:
    """(bytes, FLOPs) of one flash call, ``kernel`` 'fwd', 'dq' or 'dkv',
    without a causal mask; q, k and v are three tensors. The forward forms
    S = q k^T and P v; the dq S, dP = dO v^T and dS k; the dk/dv S, dP,
    P^T dO and dS^T q. lse and D are float32 rows; the dropout seed is 4
    bytes."""
    nbytes = itemsize * (b * h * lq * dh + b * h * lk * (dh + dv))
    nbytes += 4 if dropout else 0
    rows = 4 * b * h * lq
    pairs = b * h * lq * lk
    if kernel == "fwd":
        nbytes += itemsize * b * h * lq * dv + (rows if lse else 0)
        return nbytes, 2 * pairs * (dh + dv)
    nbytes += itemsize * b * h * lq * dv + 2 * rows
    if kernel == "dq":
        return nbytes + itemsize * b * h * lq * dh, 2 * pairs * (2 * dh + dv)
    if kernel == "dkv":
        return (nbytes + itemsize * b * h * lk * (dh + dv),
                2 * pairs * (2 * dh + 2 * dv))
    raise ValueError(f"unknown flash kernel {kernel!r}")


def resblock(b: int, h: int, w: int, cin: int, cout: int, itemsize: int, *,
             skip: bool, split_a: tuple[int, int, int] | None = None
             ) -> tuple[int, int]:
    """(bytes, FLOPs) of one residual-block call at output size (b, h, w):
    both 3 x 3 convolutions and, with ``skip``, the 1 x 1 one; its input
    (b, h, w, cin), or with ``split_a`` = (h_a, w_a, c_a) two sources, x_a
    (b, h_a, w_a, c_a) and x_b (b, h, w, cin - c_a); the weights, biases,
    the (b, cout) time bias and the output."""
    macs = b * h * w * (9 * cin * cout + 9 * cout * cout
                        + (cin * cout if skip else 0))
    if split_a is None:
        inputs = b * h * w * cin
    else:
        ha, wa, ca = split_a
        inputs = b * ha * wa * ca + b * h * w * (cin - ca)
    params = 9 * cin * cout + cout + 9 * cout * cout + cout + b * cout
    if skip:
        params += cin * cout + cout
    return itemsize * (inputs + params + b * h * w * cout), 2 * macs


def unet_resblocks(b: int, itemsize: int = 4) -> list[tuple[int, int]]:
    """The four residual-block calls of one SimpleUNet forward at batch
    ``b``: rb1 1 -> 32 at 28 x 28, rb2 32 -> 64 and rb3 64 -> 64 at 14 x
    14, rb4 from two sources (rb3's output at 14 x 14 and rb1's) to 32."""
    return [resblock(b, 28, 28, 1, 32, itemsize, skip=True),
            resblock(b, 14, 14, 32, 64, itemsize, skip=True),
            resblock(b, 14, 14, 64, 64, itemsize, skip=False),
            resblock(b, 28, 28, 96, 32, itemsize, skip=True,
                     split_a=(14, 14, 64))]
