"""The ceilings of one NVIDIA H100 SXM (data sheet, dense, 700 W): every
roofline share and every ``mfu`` is taken against these, whatever
precision the work ran in, so a share reads the same work alike whatever
implements it."""

PEAK_FLOPS = 989e12     # dense bf16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12   # HBM3 bytes/s


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take for work moving ``nbytes`` and
    doing ``flops``: the larger of the two times."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS)
