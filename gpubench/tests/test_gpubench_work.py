"""The benchmark's frozen counts against what they stand for: a step's
FLOPs against ``torch.utils.flop_counter`` on the plain reference, a
kernel call's bytes and FLOPs against the program's own ``work``
functions; and the trace arithmetic (device time as a union, idle gaps,
roofline shares) on synthetic event lists."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import trace, weights
from gpubench.reference import keytree
from gpubench.reference import text as ref_text
from gpubench.reference import unet as ref_unet
from gpubench.reference.diffusion import Schedule
from gpubench.work import flops, kernels, peaks

TEXT = dict(dim=32, heads=4, depth=2, ffn=48, vocab=96)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _text_params(gen, **kw):
    specs = (weights.transformer(kw["dim"], kw["depth"], kw["ffn"])
             + weights.rounding(kw["dim"], kw["vocab"]))
    return weights.draw(specs, gen, "cpu")


@pytest.mark.parametrize("batch,length", [(2, 8), (3, 5)])
def test_text_train_step_flops(batch, length):
    p = {k: v.clone().requires_grad_()
         for k, v in _text_params(torch.Generator().manual_seed(0),
                                  **TEXT).items()}
    den = {k: v for k, v in p.items() if not k.startswith("decoder.")}
    rnd = {k: v for k, v in p.items() if k.startswith("decoder.")}
    table = torch.randn(TEXT["vocab"], TEXT["dim"])
    tokens = torch.randint(TEXT["vocab"], (batch, length))

    def step():
        *_, total = ref_text.train_losses(
            den, rnd, table, tokens, keytree.prng_key(3),
            sched=Schedule(20, "cpu"), heads=TEXT["heads"],
            depth=TEXT["depth"], rate=0.1, rounding_weight=1.0)
        torch.autograd.grad(total, list(p.values()))

    want = flops.text_train_step(batch, length, TEXT["dim"], TEXT["heads"],
                                 TEXT["depth"], TEXT["ffn"], TEXT["vocab"])
    assert _counted(step) == want


def test_text_sample_batch_flops():
    n, length, steps = 3, 6, 4
    p = _text_params(torch.Generator().manual_seed(1), **TEXT)

    def batch():
        x = torch.randn(n, length, TEXT["dim"])
        for t in range(steps):
            x = ref_text.denoise(p, x, torch.full((n,), t),
                                 heads=TEXT["heads"], depth=TEXT["depth"],
                                 timesteps=steps)
        ref_text.rounding_logits(p, x)

    want = flops.text_sample_batch(n, length, TEXT["dim"], TEXT["heads"],
                                   TEXT["depth"], TEXT["ffn"], TEXT["vocab"],
                                   steps)
    assert _counted(batch) == want


@pytest.mark.parametrize("batch", [1, 3])
def test_unet_step_flops(batch):
    params = weights.draw(weights.unet(ref_unet.BLOCKS),
                          torch.Generator().manual_seed(2), "cpu")
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = torch.randn(batch, 28, 28, 1)
    t = torch.randint(10, (batch,))

    def train():
        loss = ref_unet.denoise(p, x, t, timesteps=10).square().mean()
        torch.autograd.grad(loss, list(p.values()))

    assert _counted(train) == flops.unet_train_step(batch)
    with torch.no_grad():
        fwd = _counted(lambda: ref_unet.denoise(p, x, t, timesteps=10))
    assert 7 * fwd == flops.unet_sample_batch(batch, 7)


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (1, 4, 64, 512)])
def test_flash_counts_match_the_program(kernel, shape):
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    b, heads, length, dh = shape
    qkv = torch.zeros(b, length, 3 * heads * dh)
    q, k, v = (a.reshape(b, length, heads, dh)
               for a in qkv.split(heads * dh, dim=-1))
    for lse in (True, False):
        if kernel != "fwd" and not lse:
            continue
        got = kernels.flash(kernel, b, heads, length, length, dh, dh, 4,
                            dropout=True, lse=lse)
        assert got == fa.work(kernel, q, k, v, layout="blhd",
                              dropout_rate=0.1, lse=lse)


@pytest.mark.parametrize("batch", [1, 256])
def test_resblock_counts_match_the_program(batch):
    from tinydiffusionmodels_torch.ops import resblock

    ours = kernels.unet_resblocks(batch)
    got = []
    for name, (cin, cout) in ref_unet.BLOCKS.items():
        hw = 28 if name in ("rb1", "rb4") else 14
        w = [torch.zeros(cout, cin, 3, 3), torch.zeros(cout),
             torch.zeros(cout, cout, 3, 3), torch.zeros(cout),
             torch.zeros(batch, 1, 1, cout)]
        skip = ([torch.zeros(cout, cin, 1, 1), torch.zeros(cout)]
                if cin != cout else [])
        if name == "rb4":
            got.append(resblock.work(torch.zeros(batch, 14, 14, 64), *w,
                                     *skip, x_b=torch.zeros(batch, 28, 28, 32),
                                     upsample_a=2))
        else:
            got.append(resblock.work(torch.zeros(batch, hw, hw, cin), *w,
                                     *skip))
    assert ours == got


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def _trace(device, host=(), window=(0.0, 10.0), steps=4):
    return trace.Trace([trace.Event(*e) for e in device],
                       [trace.Event(*e) for e in host], window, steps=steps)


def test_busy_time_is_a_union_inside_the_window():
    t = _trace([("k_a", 1.0, 3.0), ("k_b", 2.0, 4.0), ("k_a", 6.0, 7.0),
                ("Memcpy HtoD", 6.5, 8.0), ("k_c", 9.5, 12.0)])
    assert t.busy_s == pytest.approx(3.0 + 2.0 + 0.5)
    assert t.window_s == 10.0
    assert len(t.kernels) == 4        # the copy is no kernel
    assert t.gaps() == [(0.0, 1.0), (4.0, 6.0), (8.0, 9.5)]


def test_idle_gaps_are_named_by_the_host():
    t = _trace([("k", 1.0, 2.0), ("k", 5.0, 6.0)],
               host=[("gpubench.chunk", 0.5, 9.0),
                     ("cudaStreamSynchronize", 2.5, 4.8)])
    b = t.breakdown()
    assert b["device_ops"] == [["k", 2.0]]
    names = dict(b["idle_gaps"])
    assert names["cudaStreamSynchronize"] == pytest.approx(3.0)
    assert names["gpubench.chunk"] == pytest.approx(1.0 + 4.0)


def test_roofline_share_takes_calls_round_by_round():
    t = _trace([("fused_resblock_kernel", 0.0, 1.0)] * 6
               + [("flash_wide_fwd_kernel", 0.0, 2.0)])
    bounds = [0.1, 0.2, 0.3, 0.4]
    got = trace.roofline_pct(t, [("resblock", bounds)])
    assert got == pytest.approx(100.0 * (1.0 + 0.1 + 0.2) / 6.0)
    both = trace.roofline_pct(t, [("resblock", bounds),
                                  ("flash_wide_fwd", [0.5])])
    assert both == pytest.approx(100.0 * (1.3 + 0.5) / 8.0)
    assert trace.roofline_pct(t, [("flash_wide_dq", [0.5])]) is None
    assert trace.roofline_pct(t, None) is None


def test_rates_from_a_window():
    from gpubench import harness

    w = harness.Window(seconds=2.0, units=3, steps=75, examples=2400,
                       flops=75 * 1e12)
    run = harness.Run(None, type("R", (), {"kind": "train"})(), 12.5, w,
                      _trace([("k", 0.0, 1.0)], window=(0.0, 4.0),
                             steps=75), 0)
    assert harness.reader("train_examples_s")(run) == 1200.0
    assert harness.reader("samples_s")(run) is None
    assert harness.reader("setup_s")(run) == 12.5
    assert harness.reader("idle_pct.train")(run) == pytest.approx(75.0)
    assert harness.reader("idle_pct.sample")(run) is None
    assert harness.reader("mfu.train")(run) == pytest.approx(
        100.0 * 75e12 / 4.0 / 989e12)
    assert harness.reader("kernels_per_step.train")(run) == \
        pytest.approx(1 / 75)
    assert math.isclose(peaks.PEAK_FLOPS, 989e12)
