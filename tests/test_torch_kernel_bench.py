"""``python -m tinydiffusionmodels_torch.kernel_bench`` on the CPU.

Each mode runs under ``TDM_PLATFORM=cpu`` at tiny shapes (the plain
versions, timed on the host clock) and returns its lines as rows that name
the implementations. Without a GPU and without ``TDM_PLATFORM=cpu`` the tool
exits non-zero. Its mode and shape tables equal the JAX tool's
(``tools/kernel_bench.py``), whose literals are copied here: importing that
tool would turn on the JAX compile cache.
"""

import os
import subprocess
import sys

import pytest
import torch

from tinydiffusionmodels_torch import kernel_bench as kb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(iters=1, warmup=0)

# tools/kernel_bench.py: bench_resblock, bench_attention,
# bench_attention_grad, bench_attention_bf16 and the modes of its main.
JAX_RESBLOCK = [(128, 28, 28, 1, 32), (128, 14, 14, 32, 64),
                (128, 14, 14, 64, 64), (128, 28, 28, 96, 32)]
JAX_ATTENTION = [(8, 4, 64, 64), (8, 4, 512, 64), (2, 4, 2048, 64)]
JAX_BF16 = [(8, 4, 512, 64), (4, 4, 1024, 64), (8, 4, 1024, 64),
            (2, 4, 2048, 64)]
JAX_MODES = ("resblock", "attention", "grad", "bf16")


@pytest.fixture()
def cpu(monkeypatch):
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    torch.set_num_threads(1)


def test_tables_equal_the_jax_tool():
    assert list(kb.RESBLOCK_SHAPES) == JAX_RESBLOCK
    assert list(kb.ATTENTION_SHAPES) == JAX_ATTENTION
    assert list(kb.BF16_SHAPES) == JAX_BF16
    assert kb.MODES == JAX_MODES and set(kb.BENCHES) == set(JAX_MODES)
    assert kb.SINGLE_BLOCK_MAX_L == 128 and kb.DROPOUT == 0.1


def test_resblock_rows(cpu, capsys):
    rows = kb.bench_resblock([(2, 6, 6, 32, 64), (1, 5, 5, 64, 64)], **TINY)
    assert [(r.shape, r.impl) for r in rows] == [
        ((2, 6, 6, 32, 64), "plain"), ((2, 6, 6, 32, 64), "kernel"),
        ((1, 5, 5, 64, 64), "plain"), ((1, 5, 5, 64, 64), "kernel")]
    assert all(r.mode == "resblock" and r.us > 0 and r.bound_share is None
               for r in rows)
    assert "resblock B2 6x6  32-> 64 kernel      :" in capsys.readouterr().out


@pytest.mark.parametrize("bench, mode, label", [
    (kb.bench_attention, "attention", "attention"),
    (kb.bench_attention_grad, "grad", "attn-grad"),
])
def test_attention_rows_time_single_block_up_to_l128(cpu, capsys, bench,
                                                     mode, label):
    rows = bench([(1, 2, 16, 32), (1, 1, 130, 32)], **TINY)
    assert [(r.shape[2], r.impl) for r in rows] == [
        (16, "plain"), (16, "single_block"), (16, "flash"),
        (130, "plain"), (130, "flash")]
    assert all(r.mode == mode and r.us > 0 and r.tflops > 0 for r in rows)
    out = capsys.readouterr().out
    assert f"{label} B1 H2 L   16 Dh32 single_block:" in out
    assert "host clock" in out


def test_bf16_rows(cpu, capsys):
    rows = kb.bench_attention_bf16([(1, 2, 16, 32)], **TINY)
    assert [r.impl for r in rows] == ["plain", "flash", "plain", "flash"]
    out = capsys.readouterr().out
    assert ("attn-bf16 B1 H2 L   16 (    0MB f32-scores) flash        fwd :"
            in out)
    assert "flash        grad:" in out


def test_main_runs_the_named_modes(cpu, monkeypatch, capsys):
    ran = []
    for mode in kb.MODES:
        monkeypatch.setitem(kb.BENCHES, mode,
                            lambda device, mode=mode: ran.append(
                                (mode, device.type)) or [mode])
    assert kb.main(["grad"]) == ["grad"] and ran == [("grad", "cpu")]
    assert kb.main([]) == list(kb.MODES)
    assert "kernel bench on cpu" in capsys.readouterr().out


def test_no_gpu_and_no_cpu_opt_in_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    env = {k: v for k, v in os.environ.items() if k != "TDM_PLATFORM"}
    proc = subprocess.run(
        [sys.executable, "-m", "tinydiffusionmodels_torch.kernel_bench",
         "attention"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "TDM_PLATFORM=cpu" in proc.stderr and proc.stdout == ""
