"""The port's ``perf.py``: device peaks, FLOP counting, MFU, the bound and
the timer, on the CPU. The peak table is read through a patched device name,
because this machine has no card."""

import math
import subprocess
import sys

import pytest
import torch

from tinydiffusionmodels_torch import perf

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def card(monkeypatch):
    """Pretend the current CUDA device is named ``name``."""
    def use(name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda index=None: name)
    return use


def test_h100_peaks(card):
    card(H100)
    assert perf.device_peak_flops() == 989e12
    assert perf.device_peak_flops(dtype="bf16") == 989e12
    assert perf.device_peak_flops("cuda", dtype="f32") == 67e12
    assert perf.device_peak_flops(torch.device("cuda", 0), "f32") == 67e12
    assert perf.device_peak_flops(dtype="tf32") == 495e12
    assert perf.device_hbm_bandwidth() == 3.35e12


def test_unknown_card_and_cpu_have_no_peak(card):
    assert perf.device_peak_flops("cpu") is None
    assert perf.device_hbm_bandwidth(torch.device("cpu")) is None
    card("NVIDIA A100-SXM4-80GB")
    assert perf.device_peak_flops() is None
    assert perf.device_hbm_bandwidth() is None
    assert perf.device_peak_flops("cpu") is None


def test_no_gpu_has_no_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert perf.device_peak_flops() is None
    assert perf.device_hbm_bandwidth() is None


@pytest.mark.parametrize("m, n, k", [(3, 5, 7), (64, 32, 16)])
def test_compiled_flops_of_a_matmul(m, n, k):
    a, b = torch.randn(m, k), torch.randn(k, n)
    assert perf.compiled_flops(torch.matmul, a, b) == 2 * m * n * k
    assert perf.compiled_flops(lambda x: x + 1, a) is None


def test_mfu(card):
    assert perf.mfu(1e12, 10.0, device="cpu") is None
    card(H100)
    assert perf.mfu(1e12, 10.0) == pytest.approx(1e13 / 989e12)
    assert perf.mfu(1e12, 10.0, dtype="f32") == pytest.approx(1e13 / 67e12)
    assert perf.mfu(None, 10.0) is None


def _old_bound(nbytes, ops):
    """``chip_smoke._bound`` as it stood before it moved to perf.py."""
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = sum(flops / rate for flops, rate in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def test_bound_ms_is_the_old_chip_smoke_bound(card):
    # Row 1 of the kernel table: the flash forward at the training shape.
    # The old bound took rates; bound_ms takes dtypes and looks them up.
    card(H100)
    rates = {"f32": 67e12, "bf16": 989e12}
    b, l, h, d = 8, 64, 4, 64
    n_qkv, n_row, pairs = b * l * h * d, b * h * l, b * h * l * l
    cases = [((4 * n_qkv + n_row) * 4 + 4, [(2 * pairs * 2 * d, "f32")]),
             ((6 * n_qkv + 2 * n_row) * 4 + 4, [(2 * pairs * 4 * d, "f32")]),
             (10, [(1e9, "bf16"), (1e6, "f32")])]
    for nbytes, ops in cases:
        assert perf.bound_ms(nbytes, ops) == _old_bound(
            nbytes, [(flops, rates[dtype]) for flops, dtype in ops])
    ms, by = perf.bound_ms(*cases[0])
    # PERF.md's row 1: 0.00063 ms, by bytes.
    assert by == "bytes" and math.isclose(ms, 2105348 / 3.35e12 * 1e3)
    assert round(ms, 5) == 0.00063
    assert perf.bound_ms(0, [(67e9, "f32")]) == (1.0, "operations")


def test_tf32_peak_and_the_3xtf32_bound(card):
    """The flash kernels' f32 products run as 3xTF32 on the tensor cores:
    three TF32 products per f32 product, at the data sheet's dense TF32
    peak; that bound is below the FP32-FMA roof of the same FLOPs."""
    card(H100)
    assert perf.device_peak_flops(dtype="tf32") == 495e12
    flops = 2 * 8 * 4 * 64 * 64 * (64 + 64)   # the forward at (8, 4, 64, 64)
    assert perf.f32_tensor_core_ops(flops) == [(3 * flops, "tf32")]
    ms, by = perf.bound_ms(0, perf.f32_tensor_core_ops(flops))
    assert by == "operations"
    assert math.isclose(ms, 3 * flops / 495e12 * 1e3)
    fma_roof = perf.bound_ms(0, [(flops, "f32")])[0]
    assert math.isclose(ms / fma_roof, 3 * 67 / 495)
    # At the training shape the bytes still bound the forward.
    nbytes = (4 * 8 * 64 * 4 * 64 + 8 * 4 * 64) * 4 + 4
    assert perf.bound_ms(nbytes, perf.f32_tensor_core_ops(flops)) == (
        nbytes / 3.35e12 * 1e3, "bytes")


def test_bound_ms_is_none_without_the_cards_peaks(card):
    assert perf.bound_ms(10, [(1e6, "f32")], device="cpu") is None
    card("NVIDIA A100-SXM4-80GB")
    assert perf.bound_ms(10, [(1e6, "f32")]) is None


def test_device_ms_on_the_cpu_calls_warmup_plus_iters_times():
    calls = []
    ms = perf.device_ms(lambda: calls.append(1), iters=7, warmup=3,
                        device="cpu")
    assert len(calls) == 10 and ms >= 0.0


def test_perf_imports_no_jax():
    code = ("import sys, tinydiffusionmodels_torch.perf; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tinydiffusionmodels_tpu')]; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_card_label_is_nvidia_smis_first_line(monkeypatch):
    seen = {}

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\nother\n")

    monkeypatch.setattr(perf.subprocess, "run", run)
    assert perf.card_label() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]


# --- kernel FLOP counts (each wrapper's ``work``) ---------------------------

def _counted(fn, *args):
    """FlopCounterMode's count of ``fn(*args)``, the plain version's own
    operators, with no kernel-wrapper substitution."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def _qkv(b, h, lq, lk, dh, dv, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, h, lq, dh, generator=g),
            torch.randn(b, h, lk, dh, generator=g),
            torch.randn(b, h, lk, dv, generator=g))


FLASH_SHAPES = [(2, 3, 16, 24, 8, 8), (1, 2, 40, 40, 16, 24)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_flash_work_is_the_flop_count_of_the_plain_version(kernel, shape):
    """Within 1 % (the counts are exact): the forward against
    ``reference.attention``, dq and dk/dv against ``attention_bwd_dq`` and
    ``attention_bwd_dkv``, at dropout 0.1."""
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    q, k, v = _qkv(*shape)
    kw = dict(causal=False, layout="bhld", q_offset=0, k_offset=0,
              dropout_rate=0.1, dropout_seed=3)
    out, lse = reference.attention(q, k, v, **kw)
    g_out = torch.randn_like(out)
    delta = fa.backward_delta(out, g_out, None, "bhld")
    plain = {"fwd": lambda: reference.attention(q, k, v, **kw),
             "dq": lambda: reference.attention_bwd_dq(q, k, v, g_out, lse,
                                                      delta, **kw),
             "dkv": lambda: reference.attention_bwd_dkv(q, k, v, g_out, lse,
                                                        delta, **kw)}
    want = _counted(plain[kernel])
    assert fa.work(kernel, q, k, v, **kw)[1] == pytest.approx(want, rel=0.01)


def test_flash_work_counts_bytes_and_causal_pairs():
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    b, h, l, d = 2, 3, 16, 8
    q, k, v = _qkv(b, h, l, l, d, d)
    n, rows = q.numel(), b * h * l
    assert fa.work("fwd", q, k, v, dropout_rate=0.1)[0] == (
        4 * n + rows) * 4 + 4
    assert fa.work("dq", q, k, v)[0] == (5 * n + 2 * rows) * 4
    assert fa.work("dkv", q, k, v)[0] == (6 * n + 2 * rows) * 4
    # One tensor as q, k and v is read once; without the logsumexp.
    assert fa.work("fwd", q, q, q, lse=False) == (2 * n * 4,
                                                  2 * b * h * l * l * 2 * d)
    # Causal: query i sees keys 0..i; with k_offset 4 the first 4 see none.
    assert fa.pairs(b, h, l, l, causal=True) == b * h * l * (l + 1) // 2
    assert fa.pairs(1, 1, 6, 6, causal=True, k_offset=4) == 0 + 0 + 0 + 0 + 1 + 2
    with pytest.raises(ValueError, match="unknown flash kernel"):
        fa.work("bwd", q, k, v)


@pytest.mark.parametrize("shape", [(2, 3, 16, 8), (1, 2, 48, 32)])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_single_block_work_is_the_flop_count_of_the_plain_version(kernel,
                                                                  shape):
    from tinydiffusionmodels_torch.ops import reference, single_block

    q, k, v = _qkv(shape[0], shape[1], shape[2], shape[2], shape[3],
                   shape[3])
    g = torch.randn_like(q)
    plain = {"fwd": lambda: reference.single_block_attention(q, k, v),
             "bwd": lambda: reference.single_block_attention_bwd(q, k, v, g)}
    want = _counted(plain[kernel])
    assert single_block.work(kernel, q, k, v)[1] == pytest.approx(want,
                                                                  rel=0.01)


@pytest.mark.parametrize("b, hw, cin, cout", [(2, 14, 32, 64), (3, 28, 96, 32),
                                              (1, 14, 64, 64)])
def test_resblock_work_is_the_flop_count_of_the_plain_version(b, hw, cin,
                                                              cout):
    from tinydiffusionmodels_torch.ops import reference, resblock

    g = torch.Generator().manual_seed(0)
    args = [torch.randn(b, hw, hw, cin, generator=g),
            torch.randn(cout, cin, 3, 3, generator=g), torch.randn(cout),
            torch.randn(cout, cout, 3, 3, generator=g), torch.randn(cout),
            torch.randn(b, 1, 1, cout)]
    args += ([torch.randn(cout, cin, 1, 1), torch.randn(cout)]
             if cin != cout else [None, None])
    nbytes, flops = resblock.work(*args)
    assert flops == pytest.approx(_counted(reference.fused_resblock, *args),
                                  rel=0.01)
    assert nbytes == 4 * (sum(t.numel() for t in args if t is not None)
                          + b * hw * hw * cout)


@pytest.mark.parametrize("b, vocab, depth", [(2, 97, 1), (3, 64, 2)])
def test_decode_work_matmuls_are_the_flop_count_of_the_plain_version(
        b, vocab, depth):
    """FlopCounterMode sees the plain decode's matmuls (its attention is
    elementwise products and sums, which it does not count): they equal
    the analytic matmul FLOPs."""
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig
    from tinydiffusionmodels_torch.ops import decode_kernel, reference

    seq_len = 5
    cfg = TinyGPTConfig(vocab_size=vocab, dim=32, n_heads=4, depth=depth,
                        max_len=seq_len + 1)
    w = decode_kernel.pack_weights(TinyGPT(cfg))
    diff = torch.randn(b, seq_len, vocab)
    nbytes, mm, attn = decode_kernel.work(w, b, seq_len)
    want = _counted(lambda: reference.fused_guided_decode(w, diff, 0))
    assert mm == pytest.approx(want, rel=0.01)
    assert attn == b * 2 * 2 * 32 * depth * sum(range(1, seq_len + 1))
    assert nbytes > 2 * b * seq_len * vocab


def test_compiled_flops_counts_each_kernel_call_once():
    """Operators outside the kernels as the counter sees them; each kernel
    call by its analytic count in place of its plain version's operators:
    causal attention counts the visible pairs, not the dense products the
    plain version forms, and the backward is the dq and dk/dv kernels'."""
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    b, h, l, d = 2, 2, 12, 8
    x = torch.randn(b, h, l, d)
    w = torch.randn(d, d, requires_grad=True)

    def step():
        q = x @ w
        out = fa.flash_attention(q, q, q, causal=True)
        out.sum().backward()

    proj = 2 * b * h * l * d * d
    kw = dict(causal=True)
    q = x @ w
    kernels = sum(fa.work(kind, q, q, q, **kw)[1]
                  for kind in ("fwd", "dq", "dkv"))
    # the projection forward, and its weight gradient x^T dq
    assert perf.compiled_flops(step) == 2 * proj + kernels
    pairs = b * h * l * (l + 1) // 2
    # forward 2 products, dq 3, dk/dv 4, each of width d
    assert kernels == 2 * pairs * 9 * d
    assert kernels < sum(fa.work(kind, q, q, q)[1]
                         for kind in ("fwd", "dq", "dkv"))


def test_compiled_flops_of_the_decode_counts_its_attention():
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig
    from tinydiffusionmodels_torch.ops import decode_kernel

    cfg = TinyGPTConfig(vocab_size=50, dim=16, n_heads=2, depth=1, max_len=5)
    w = decode_kernel.pack_weights(TinyGPT(cfg))
    diff = torch.randn(2, 4, 50)
    _, mm, attn = decode_kernel.work(w, 2, 4)
    assert perf.compiled_flops(decode_kernel.fused_guided_decode, w, diff,
                               0) == mm + attn
