"""What the guided-decode kernel's wrapper computes on the host, on the CPU:
the packed weight layout (``decode_kernel.pack_fragments``) and the
per-phase tiling (``decode_kernel.plan``). The kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

- The packed layout unpacks to the (in, out) weights bit for bit, and each
  lane holds the mma.sync m16n8k16 B fragment elements of its column.
- Every phase's units cover every (batch row, output column, k32 chunk)
  cell exactly once, as the kernel numbers them, walks their K tiles and
  splits each tile over its warps.
- The plan's shared memory fits the H100's 227 KB at every width (a K tile
  too wide is cut into several), the grid is at most one CTA an SM, and at
  the bench shape every matmul phase offers at least 64 units at batch 8,
  each in one K tile.
"""

import numpy as np
import pytest
import torch

from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig
from tinydiffusionmodels_torch.ops import decode_kernel as dk
from tinydiffusionmodels_torch.core.rng import prng_key

# (K, N): the bench's matrices, the odd width D 72 (F 288), V 4097, and
# degenerate sizes.
PACK_SHAPES = [(256, 768), (256, 256), (1024, 256), (72, 216), (72, 72),
               (288, 72), (72, 4097), (1, 1), (33, 9)]
# (B, V, D, H, F): the bench shape, the odd width 72, small and degenerate
# sizes, and widths whose rows take several K tiles (D 2302 and 2304 as the
# cuda tests and chip_smoke.py decode them, D 4096, and D 14336: the width
# the kernel before the tensor-core redesign took at most).
PLAN_CASES = [(8, 4096, 256, 4, 1024), (256, 4096, 256, 4, 1024),
              (1, 97, 64, 4, 256), (16, 4097, 72, 4, 288),
              (17, 500, 72, 4, 288), (257, 4097, 72, 4, 288),
              (257, 4096, 256, 4, 1024), (13, 97, 32, 2, 128),
              (5, 97, 30, 2, 120), (3, 97, 2304, 1, 9216),
              (2, 97, 2302, 2, 9208), (8, 97, 4096, 16, 16384),
              (4, 97, 14336, 1, 1024)]


def _bf16(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).bfloat16()


@pytest.mark.parametrize("k, n", PACK_SHAPES)
def test_pack_unpacks_bit_for_bit(k, n):
    w = _bf16((k, n), k + n)
    p = dk.pack_fragments(w)
    assert p.shape == (-(-n // 8), -(-k // 32), 32, 8)
    assert p.dtype == torch.bfloat16
    assert torch.equal(dk.unpack_fragments(p, k, n), w)


@pytest.mark.parametrize("k, n", [(64, 24), (40, 17)])
def test_pack_lanes_hold_mma_b_fragments(k, n):
    """Lane 4 g + t of n8 block j, chunk c holds column 8 j + g at rows
    32 c + {2t, 2t+1, 2t+8, 2t+9} (b0, b1 of the first k16 step) and the
    same + 16 (the second); zeros past K and N."""
    w = _bf16((k, n), 3).float()
    p = dk.pack_fragments(w.bfloat16()).float()
    for j in range(p.shape[0]):
        for c in range(p.shape[1]):
            for lane in range(32):
                g, t = divmod(lane, 4)
                col = 8 * j + g
                rows = [32 * c + 16 * s + 2 * t + o
                        for s in (0, 1) for o in (0, 1, 8, 9)]
                want = [float(w[r, col]) if r < k and col < n else 0.0
                        for r in rows]
                assert p[j, c, lane].tolist() == want


def test_pack_weights_packed_fields_are_the_weights():
    cfg = TinyGPTConfig(vocab_size=97, dim=72, n_heads=4, depth=2, max_len=9)
    model = TinyGPT(cfg, key=prng_key(0)).eval()
    w = dk.pack_weights(model)
    d, f, v = 72, 288, 97
    for i in range(2):
        assert torch.equal(dk.unpack_fragments(w.qkv_p[i], d, 3 * d),
                           w.qkv_w[i])
        assert torch.equal(dk.unpack_fragments(w.proj_p[i], d, d),
                           w.proj_w[i])
        assert torch.equal(dk.unpack_fragments(w.fc_p[i], d, f), w.fc_w[i])
        assert torch.equal(dk.unpack_fragments(w.mlp_p[i], f, d), w.mlp_w[i])
    assert torch.equal(dk.unpack_fragments(w.head_p, d, v), w.head)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in w.packed())


def _phase_shape(ph, v, d, f):
    """(N, total k32 chunks) of a phase as the packed matrix has them."""
    kd = -(-d // 32)
    return {"qkv": (3 * d, kd), "proj": (d, kd), "fc": (-(-f // 8) * 8, kd),
            "mlp": (d, -(-f // 32)), "head": (v, kd)}[ph]


def _unit_cover(pp, b, n, kc):
    """The (row, column, k32 chunk) cells each unit of ``pp`` computes, as
    the kernel numbers units (row tile, k split, column group; column group
    fastest), walks a unit's chunks ``ktile`` at a time and splits each tile
    over its warps: (rows, cols, chunks), clipped to B rows, N columns and
    ``kc`` chunks."""
    nbw, ksub = pp.warp_split
    for u in range(pp.units):
        cg, rk = u % pp.col_groups, u // pp.col_groups
        ks, rt = rk % pp.ksplit, rk // pp.ksplit
        cbase = ks * pp.kchunks
        chunks = []
        for tc in range(0, pp.kchunks, pp.ktile):
            nk = min(pp.ktile, pp.kchunks - tc)
            per = -(-nk // ksub)
            for s in range(ksub):
                lo = s * per
                hi = min(nk, lo + per, kc - cbase - tc)
                chunks += [cbase + tc + c for c in range(lo, hi)]
        yield (range(rt * pp.rows, min(b, (rt + 1) * pp.rows)),
               range(cg * pp.ncols * 8, min(n, (cg + 1) * pp.ncols * 8)),
               chunks)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_covers_every_output_once(case, sms):
    b, v, d, h, f = case
    pl = dk.plan(b, v, d, h, f, sms)
    for ph in dk.PHASES:
        pp = pl.phases[ph]
        n, kc = _phase_shape(ph, v, d, f)
        seen = np.zeros((b, n, kc), dtype=np.int8)
        for rows, cols, chunks in _unit_cover(pp, b, n, kc):
            if rows and cols:
                seen[rows.start:rows.stop, cols.start:cols.stop][..., chunks] += 1
        assert (seen == 1).all(), (ph, pp)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_fits_the_card(case):
    b, v, d, h, f = case
    pl = dk.plan(b, v, d, h, f, 132)
    assert pl.smem <= dk.SMEM_MAX == 232_448
    assert 1 <= pl.grid <= 132
    assert all(o % 16 == 0 for o in (pl.red_off, pl.att_off, pl.stat_off))
    dh4 = -(-(d // h) // 4) * 4
    att = dk.WARPS * (dk.SCORE_CHUNK + 4 + min(dh4, dk.OUT_CHUNK)) * 4
    assert pl.stat_off - pl.att_off >= att
    for ph, pp in pl.phases.items():
        assert pp.rows in (16, 32, 64) and pp.ncols in (1, 2, 4, 8, 16)
        assert 1 <= pp.ktile <= pp.kchunks
        assert pp.tile_bytes(pp.ktile) <= pl.red_off
        assert pl.red_off + pp.red_bytes() <= pl.att_off
        assert pl.smem - pl.stat_off >= pp.rows * 16
        if ph in ("qkv", "fc", "head"):  # LN phases take whole rows
            assert pp.ksplit == 1 and pp.kchunks == -(-d // 32)


@pytest.mark.parametrize("b", [8, 256])
def test_bench_plan_spreads_every_phase(b):
    """At the bench shape no matmul phase runs on fewer than 64 CTAs or
    on more than one wave of the card, and every unit takes its K in one
    tile."""
    pl = dk.plan(b, 4096, 256, 4, 1024, 132)
    assert all(64 <= pp.units <= 132 for pp in pl.phases.values())
    assert all(pp.ktile == pp.kchunks for pp in pl.phases.values())
    assert pl.grid >= 64


def test_plan_cuts_wide_rows_into_k_tiles():
    """Where a unit's rows do not fit the shared memory whole, the plan cuts
    K into tiles instead of refusing: D 14336 with one head (the widest the
    kernel before the tensor-core redesign took) and F 57344."""
    pl = dk.plan(8, 97, 14336, 1, 57344, 132)
    assert pl.smem <= dk.SMEM_MAX
    assert all(pp.ktile < pp.kchunks for ph, pp in pl.phases.items()
               if ph != "head")


def test_barrier_count():
    assert dk.barriers(4, 64) == 64 * 21 == 1344
    assert dk.barriers(4, 64, normalize=True) == 64 * 22 + 1
