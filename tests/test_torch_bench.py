"""The port's bench (``python -m tinydiffusionmodels_torch.bench``) on the
CPU.

Its copies of the root ``bench.py``'s jax-free parts (the retry and
validity policy, the host-load check, the anchors, ``_emit``'s schema) are
held against the originals on the same inputs, as one parametrised test
over the cases of ``tests/test_bench_validity.py``; they must agree
exactly. Every suite function runs at tiny sizes with
``TDM_PLATFORM=cpu`` and returns 5 finite positive rates (host-clock rates
of the plain versions: no device number). ``main`` with the suite
functions replaced by recorders prints a line with ``bench.py``'s keys and
all 14 metrics, each measured by its own call.
"""

import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tinydiffusionmodels_torch import bench as port  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
root = importlib.import_module("bench")

torch.set_num_threads(1)

METRICS = [
    "shakespeare_train_it_s", "shakespeare_sample_steps_s",
    "mnist_train_it_s", "mnist_sample_samples_s", "mnist_sample_dpmpp20_s",
    "guided_tokens_s", "guided_tokens_s_bs256", "guided_fused_tokens_s",
    "guided_fused_tokens_s_bs256", "guided_verified_tokens_s_bs8",
    "guided_verified_tokens_s_bs256", "guided_spec_tokens_s_bs256",
    "mnist_train_bs512_bf16_it_s", "shakespeare_train_bs512_bf16_it_s",
]


# --- the copies against the originals ---------------------------------------

def _retry(attempts, **kw):
    def case(bench):
        it = iter(attempts)
        log = {}
        rates, flops = bench._measure_with_retry("m", lambda: next(it), log,
                                                 **kw)
        return rates, flops, log
    return case


def _validity(env, solo):
    return lambda bench: bench._run_validity(env, solo)


# The cases of tests/test_bench_validity.py, each a function of the module.
CASES = {
    "spread_tight": lambda b: b._spread_ok([100.0, 99.0, 101.0]),
    "spread_loose": lambda b: b._spread_ok([70.0, 100.0, 101.0]),
    "spread_boundary": lambda b: b._spread_ok([85.0, 100.0, 100.0]),
    "retry_tight_first_attempt": _retry([([100.0, 101.0, 99.0], 1.0)],
                                        max_retries=2),
    "retry_keeps_tightest_attempt": _retry(
        [([50.0, 100.0, 101.0], 1.0), ([98.0, 100.0, 101.0], None)],
        max_retries=2),
    "retry_median_of_attempt_medians": _retry(
        [([50.0, 100.0, 102.0], 1.0), ([60.0, 98.0, 103.0], None),
         ([55.0, 101.0, 104.0], None)], max_retries=2),
    "retry_fallback_needs_agreeing_medians": _retry(
        [([50.0, 100.0, 102.0], 1.0), ([30.0, 60.0, 75.0], None),
         ([20.0, 50.0, 65.0], None)], max_retries=2),
    "retry_default_budget_from_env": _retry(
        [([50.0, 100.0, 102.0], 1.0), ([60.0, 98.0, 103.0], None)]),
    "validity_loose_secondary": _validity(
        {"shakespeare_train_it_s": [100.0, 101.0, 99.0],
         "guided_tokens_s": [50.0, 100.0, 101.0]}, True),
    "validity_loose_headline": _validity(
        {"shakespeare_train_it_s": [50.0, 100.0, 101.0]}, True),
    "validity_not_solo": _validity(
        {"shakespeare_train_it_s": [100.0, 101.0, 99.0]}, False),
    "median": lambda b: (b._median([3.0, 1.0, 2.0]),
                         b._median([4.0, 1.0, 3.0, 2.0])),
    "load_threshold": lambda b: b._load_threshold(),
    "constants": lambda b: (b._TIGHT, b.HEADLINE_METRIC,
                            b.MNIST_REF_T4_TRAIN_IT_S,
                            b.MNIST_REF_T4_SAMPLES_S),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_root_bench(case, monkeypatch):
    monkeypatch.setenv("TDM_BENCH_RETRIES", "1")
    monkeypatch.setenv("TDM_BENCH_QUIET_WAIT", "0")
    for bench in (root, port):
        monkeypatch.setattr(bench, "_wait_for_quiet", lambda *_: True)
    assert CASES[case](port) == CASES[case](root)


def test_wait_for_quiet_copy_matches_root(monkeypatch):
    for bench in (root, port):
        monkeypatch.setattr(bench, "_quiet_host", lambda: False)
        assert bench._wait_for_quiet(0.0) is False
        monkeypatch.setattr(bench, "_quiet_host", lambda: True)
        assert bench._wait_for_quiet(0.0) is True


def _emitted(bench, capsys, **kw):
    r = {name: 10.0 + i for i, name in enumerate(METRICS)}
    bench._emit(None, r, {"shakespeare_train_it_s": 0.001},
                {"shakespeare_train_it_s": [1.0, 2.0, 3.0]}, "cuda",
                "NVIDIA H100 80GB HBM3, 700.00 W", 989e12,
                {"solo_run": True}, **kw)
    return json.loads(capsys.readouterr().out.strip())


@pytest.mark.parametrize("kw", [
    pytest.param(dict(), id="valid"),
    pytest.param(dict(valid=False, invalid_reasons=["host not solo"],
                      metric_valid={"guided_tokens_s": False},
                      loose_metrics=["guided_tokens_s"]), id="invalid"),
])
def test_emit_schema_matches_root(capsys, kw):
    assert _emitted(port, capsys, **kw) == _emitted(root, capsys, **kw)


# --- imports and the device -------------------------------------------------

def test_bench_imports_no_jax_and_needs_a_card(tmp_path):
    """In a process where jax and the JAX package cannot be imported the
    bench imports; without a GPU and without TDM_PLATFORM=cpu it exits
    non-zero and prints no result."""
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'tinydiffusionmodels_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import tinydiffusionmodels_torch.bench as b\n"
            "b.main([])\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=180,
                          env=env)
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert proc.returncode != 0
    assert "TDM_PLATFORM=cpu" in proc.stderr and proc.stdout == ""
    assert "ModuleNotFoundError" not in proc.stderr


# --- the suite at tiny sizes on the CPU -------------------------------------

TEXT = dict(batch_size=2, seq_len=8, dim=16, depth=1, vocab=32, chunk=2)
GUIDED = dict(seq_len=4, vocab=32, dim=16, depth=1)
SUITE = {
    "text_train": (lambda: port.bench_text_train(**TEXT), True),
    "text_train_bf16": (lambda: port.bench_text_train(
        **TEXT, compute_dtype=torch.bfloat16), True),
    "text_sample": (lambda: port.bench_text_sample(
        2, 8, 16, quick=True, depth=1, timesteps=4), True),
    "mnist_train": (lambda: port.bench_mnist_train(2, chunk=2), True),
    "mnist_train_bf16": (lambda: port.bench_mnist_train(
        2, chunk=2, compute_dtype=torch.bfloat16), True),
    "mnist_sample": (lambda: port.bench_mnist_sample(
        2, quick=True, timesteps=4), True),
    "mnist_sample_dpmpp": (lambda: port.bench_mnist_sample(
        2, quick=True, method="dpm++", num_steps=2, timesteps=10), True),
    "guided": (lambda: port.bench_guided(2, **GUIDED), True),
    "guided_fused": (lambda: port.bench_guided_fused(2, **GUIDED), False),
    "guided_verified": (lambda: port.bench_guided_verified(2, **GUIDED),
                        False),
    "guided_spec": (lambda: port.bench_guided_verified(
        3, draft="scan_bf16", **GUIDED), False),
}


@pytest.mark.parametrize("name", sorted(SUITE))
def test_suite_function_returns_five_rates(name, monkeypatch):
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    monkeypatch.setattr(port, "_min_window_s", lambda n: 0.01)
    fn, has_flops = SUITE[name]
    rates, flops = fn()
    assert len(rates) == 5
    assert all(math.isfinite(x) and x > 0 for x in rates)
    if has_flops:
        assert flops is not None and flops > 0
    else:
        assert flops is None


def test_train_chunk_is_k_steps_and_one_sync(monkeypatch):
    """A window is two chunks of ``chunk`` train steps; the rate counts
    every step; the warm-up chunk is not timed."""
    calls = []
    rates = port._chunk_windows(lambda: calls.append(1), 7,
                                torch.device("cpu"), windows=5)
    assert len(calls) == 1 + 5 * 2 and len(rates) == 5


def test_decode_windows_fill_the_minimum(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(port.time, "perf_counter", lambda: clock[0])
    calls = []

    def decode():
        calls.append(1)
        clock[0] += 0.1

    secs = port._decode_windows(decode, torch.device("cpu"), 0.55)
    # warm-up, probe (0.1 s), then 5 windows of ceil(0.55 / 0.1) = 6
    assert len(calls) == 2 + 5 * 6
    assert secs == pytest.approx([0.1] * 5)


def test_main_prints_every_metric_each_from_its_own_call(monkeypatch,
                                                         capsys):
    """``main`` with the suite functions replaced by recorders: 14 metrics,
    each from its own call (guided_verified_tokens_s_bs256 is
    ``bench_guided_verified(n=256)``'s, not another metric's windows),
    bench.py's keys, a loose metric listed once, mfu for the train and
    sample metrics only."""
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    monkeypatch.setenv("TDM_BENCH_RETRIES", "0")
    calls = []

    def recorder(name, flops):
        def fn(*args, **kwargs):
            calls.append((name, args, kwargs))
            base = float(len(calls))
            rates = [base, base, base, base, base]
            if (name, kwargs.get("n")) == ("guided", 256):
                rates[0] = 0.5 * base   # loose
            return rates, flops
        return fn

    for fn, flops in (("text_train", 1e9), ("text_sample", 1e9),
                      ("mnist_train", 1e9), ("mnist_sample", 1e9),
                      ("guided", 1e6), ("guided_fused", None),
                      ("guided_verified", None)):
        monkeypatch.setattr(port, f"bench_{fn}", recorder(fn, flops))
    monkeypatch.setattr(port.perf, "device_peak_flops",
                        lambda *a, **k: 1e15)
    port.main(["--quick"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    assert len(calls) == 14
    verified = [(args, kw) for name, args, kw in calls
                if name == "guided_verified"]
    assert [kw.get("n") for _, kw in verified] == [8, 256, 256]
    assert [kw.get("draft", "auto") for _, kw in verified] == [
        "auto", "auto", "scan_bf16"]
    env = line["extra"]["envelope"]
    assert sorted(env) == sorted(METRICS)
    assert env["guided_verified_tokens_s_bs256"][1] == 11.0
    assert env["guided_tokens_s_bs256"][1] == 7.0
    assert line["loose_metrics"] == ["guided_tokens_s_bs256"]
    assert set(line["extra"]["mfu"]) == {
        "shakespeare_train_it_s", "shakespeare_sample_steps_s",
        "mnist_train_it_s", "mnist_sample_samples_s",
        "mnist_sample_dpmpp20_s", "guided_tokens_s", "guided_tokens_s_bs256",
        "mnist_train_bs512_bf16_it_s", "shakespeare_train_bs512_bf16_it_s"}
    bf16 = [kw for name, _, kw in calls if kw.get("compute_dtype")]
    assert [kw["chunk"] for kw in bf16] == [20, 20]
    assert [kw["batch_size"] for kw in bf16] == [512, 512]
    assert line["extra"]["backend"] == "cpu"
    assert line["extra"]["provenance"]["scan_chunk"] == {"f32": 200,
                                                         "bf16": 20}
    assert sorted(line["extra"]["provenance"]["jacobi"]) == [
        "guided_spec_tokens_s_bs256", "guided_verified_tokens_s_bs256",
        "guided_verified_tokens_s_bs8"]

    r = {name: 1.0 for name in METRICS}
    root._emit(None, r, {}, {}, "x", "x", None, {}, valid=False,
               invalid_reasons=["x"], metric_valid={},
               loose_metrics=["x"])
    want = json.loads(capsys.readouterr().out)
    assert set(line) <= set(want) and set(line["extra"]) == set(
        want["extra"])


@pytest.mark.parametrize("draft, rounds", [("fused", True),
                                           ("scan_bf16", True),
                                           ("auto", False)])
def test_verified_bench_notes_its_rounds(draft, rounds, monkeypatch):
    """``bench_guided_verified(notes=...)`` records the draft ``auto``
    resolved to, the Jacobi rounds of a decode and the ms of a round (None
    for the plain scan, which runs none)."""
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    monkeypatch.setattr(port, "_min_window_s", lambda n: 0.01)
    notes = {}
    port.bench_guided_verified(2, draft=draft, notes=notes, **GUIDED)
    assert notes["draft"] == ("plain" if draft == "auto" else draft)
    if rounds:
        assert notes["jacobi_rounds"] >= 1
        assert notes["verify_ms_per_round"] > 0
    else:
        assert notes["jacobi_rounds"] == 0
        assert notes["verify_ms_per_round"] is None
