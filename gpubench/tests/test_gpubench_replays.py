"""The split of the window's idle time by replays (``gpubench/replays.py``)
on synthetic traces: its three parts, what lands in each, when it gives
no reading; and the readers that exist reading the same with the
correlation id filled in."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gpubench import harness, replays, trace

# Two 25-step chunks cut to two replays each, on a 20 s window. Host:
# (name, start, end, link); the host runs ahead of the device.
HOST = [
    ("tdm.train.chunk", 0.5, 10.0, 0),
    ("tdm.graph.replay", 0.6, 0.7, 0), ("cudaGraphLaunch", 0.62, 0.68, 101),
    ("tdm.graph.replay", 0.8, 0.9, 0), ("cudaGraphLaunch", 0.82, 0.88, 102),
    ("tdm.train.read", 1.0, 9.9, 0), ("cudaMemcpyAsync", 1.05, 9.8, 900),
    ("tdm.train.chunk", 10.0, 19.0, 0),
    ("tdm.graph.replay", 10.1, 10.2, 0),
    ("cudaGraphLaunch", 10.12, 10.18, 103),
    ("tdm.graph.replay", 10.3, 10.4, 0),
    ("cudaGraphLaunch", 10.32, 10.38, 104),
    ("tdm.train.read", 10.5, 18.9, 0), ("cudaMemcpyAsync", 10.55, 18.8, 901),
]
DEVICE = [
    ("k_a", 2.0, 3.0, 101), ("k_b", 3.5, 4.0, 101),     # 0.5 s in replay 1
    ("k_a", 4.25, 5.0, 102), ("k_b", 5.0, 5.5, 102),    # 0.25 s before it
    ("Memcpy DtoH", 5.6, 5.7, 900),                     # chunk 1's read
    ("k_a", 11.0, 12.0, 103),
    ("k_a", 12.5, 13.0, 104),                           # 0.5 s before it
    ("Memcpy DtoH", 13.1, 13.2, 901),
]
WINDOW = (0.0, 20.0)
BUSY = 1.0 + 0.5 + 0.75 + 0.5 + 0.1 + 1.0 + 0.5 + 0.1


def _events(rows, linked=True):
    if linked:
        return [replays.Linked(*r) for r in rows]
    return [trace.Event(*r[:3]) for r in rows]


def _split(device=DEVICE, host=HOST, steps=4):
    return replays.split(_events(device), _events(host), WINDOW, steps)


def test_the_parts_add_up_to_the_idle_share():
    got = _split()
    assert got["idle_pct"] == pytest.approx(100.0 * (20.0 - BUSY) / 20.0)
    assert got["in_replay_pct"] + got["between_replays_pct"] \
        + got["host_pct"] == pytest.approx(got["idle_pct"])
    assert got["replays"] == 4
    assert sum(got["host_s"].values()) == pytest.approx(
        got["host_pct"] * 20.0 / 100.0)


def test_each_gap_lands_in_its_part():
    """The gap between replay 1's two kernels is in a replay; the gaps
    from replay 1 to 2 and from 3 to 4 lie between replays of one chunk;
    the gaps around chunk 1's read, from chunk 1's last replay to chunk
    2's first, and the window's edges are the host's."""
    got = _split()
    assert got["in_replay_pct"] == pytest.approx(100.0 * 0.5 / 20.0)
    assert got["between_replays_pct"] == pytest.approx(
        100.0 * (0.25 + 0.5) / 20.0)
    host = 2.0 + 0.1 + (11.0 - 5.7) + 0.1 + (20.0 - 13.2)
    assert got["host_pct"] == pytest.approx(100.0 * host / 20.0)
    # Every host gap's midpoint lies in a chunk's read.
    assert list(got["host_s"]) == ["tdm.train.read"]
    assert got["host_s"]["tdm.train.read"] == pytest.approx(host)


def test_replays_of_two_chunks_are_not_between_replays():
    """Without the chunk spans no two replays share a unit: the gaps
    between them are the host's."""
    host = [r for r in HOST if r[0] != "tdm.train.chunk"]
    got = _split(host=host)
    assert got["between_replays_pct"] == 0.0
    assert got["in_replay_pct"] == pytest.approx(100.0 * 0.5 / 20.0)
    assert got["host_pct"] == pytest.approx(_split()["host_pct"]
                                            + 100.0 * 0.75 / 20.0)


@pytest.mark.parametrize("case", ["no_link", "no_ops", "no_launch",
                                  "more_steps", "no_replay"])
def test_no_reading_rather_than_a_guess(case):
    device, host, steps = DEVICE, HOST, 4
    if case == "no_link":          # replay 4's ops carry no link
        device = [r[:3] + ((0,) if r[3] == 104 else r[3:]) for r in DEVICE]
    elif case == "no_ops":         # its launch links to nothing
        host = [r[:3] + ((555,) if r[3] == 104 else r[3:]) for r in HOST]
    elif case == "no_launch":      # a replay span without its launch
        host = [r for r in HOST if r[3] != 104]
    elif case == "more_steps":     # replay spans unequal to the steps
        steps = 5
    else:
        host = [r for r in HOST if r[0] not in ("tdm.graph.replay",
                                                "cudaGraphLaunch")]
        steps = 0
    assert _split(device, host, steps) is None


def test_coverage_counts_what_the_profile_holds():
    host, device = _events(HOST), _events(DEVICE)
    assert replays.coverage(device, host, WINDOW) == {
        "replay_spans": 4, "launches": 4, "linked": 4}
    unlinked = [e for e in device if e.link != 104]
    assert replays.coverage(unlinked, host, WINDOW)["linked"] == 3


def _readings(linked: bool) -> dict:
    tr = trace.Trace(_events(DEVICE, linked), _events(HOST, linked), WINDOW,
                     steps=4)
    w = harness.Window(seconds=20.0, units=2, steps=4, examples=512,
                       flops=4e12)
    run = harness.Run(None, type("R", (), {"kind": "train"})(), 1.0, w, tr, 0)
    out = {name: harness.reader(name)(run)
           for name in ("idle_pct.train", "mfu.train",
                        "kernels_per_step.train", "train_examples_s")}
    out.update(busy_s=tr.busy_s, gaps=tr.gaps(), breakdown=tr.breakdown(),
               kernels=len(tr.kernels),
               roofline=trace.roofline_pct(tr, [("k_a", [0.1, 0.2])]))
    return out


def test_readers_read_the_same_with_links():
    assert _readings(linked=True) == _readings(linked=False)


def test_linked_events_are_the_trace_events_with_their_links():
    """On a CPU profile: the same events, windows and order as
    ``trace.events``, each with the kineto event's correlation id."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.window_span():
            torch.ones(3).add_(1)
    plain = trace.events(prof)
    linked = replays.linked_events(prof)
    assert linked[2] == plain[2]
    for a, b in zip(linked[:2], plain[:2]):
        assert [trace.Event(e.name, e.start, e.end) for e in a] == b
    assert all(e.link > 0 for e in linked[1])
    assert all(dataclasses.is_dataclass(e) for e in linked[1])


@pytest.mark.parametrize("cell", ["mnist_unet.train_bs128",
                                  "textdiff_d2048.sample_n10"])
def test_measure_runs_a_tiny_cell_on_the_cpu(tmp_path, monkeypatch, cell):
    """The tool's path end to end at a tiny size: on the CPU every step
    runs eagerly, so there is no replay to split, but the window holds
    the program's spans."""
    from gpubench.tests import tiny

    monkeypatch.setenv("TDM_FAST_NOISE", "1")
    root = tiny.make_root(tmp_path)
    got = replays.measure(root, cell, seed=2**31 + 5, units=1,
                          device=torch.device("cpu"))
    assert got["split"] is None and got["steps"] > 0
    assert got["coverage"]["launches"] == 0
    assert got["spans"] > 0
    assert got["steps_s_traced"] > 0 and got["steps_s_plain"] > 0
    assert got["span"]["on_us"] > got["span"]["off_us"] > 0
