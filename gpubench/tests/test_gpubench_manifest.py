"""``BENCHMARK.json`` and the files it names: its shapes and
characters, every name found as a file, every per-layer metric's cells
reporting the end-to-end metric it moves; and ``run.py`` refusing to run
without a card, printing no result."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from gpubench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24      # the most cells a benchmark may grow to
    assert 2 + 14 * cells <= 43200 and \
        (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 \
        <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"].startswith("gpubench/")
        assert (REPO / c["file"]).is_file()
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads_name_their_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        data = json.loads((REPO / "gpubench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert data["name"] == w["name"] and data["config"] == w["config"]
        assert data["why"] == w["why"] and data["chips"] == w["chips"]
        assert (REPO / "gpubench" / "builders"
                / f"{data['builder']}.py").is_file()
        assert data["limits"] and all(v > 0 for v in data["limits"].values())
    assert len({w["name"] for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])


def _reports(cell: str) -> set[str]:
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = BENCH["end_to_end"]
    names = [m["name"] for m in e2e + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names and 1 <= len(e2e) <= 16
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] <= 0.25
    for m in e2e + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert (REPO / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        layers.setdefault(m["layer"], m["layer"])
        for cell in m["workloads"]:
            assert m["moves"] in _reports(cell), (m["name"], cell)
    for cell in cells:
        reported = _reports(cell)
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_layers_are_perf_mds():
    perf = (REPO / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"| {layer} |" in perf, layer


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(REPO / "gpubench" / "run.py"), "--workload",
         cell, "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
