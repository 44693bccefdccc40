"""The port's multi-process dry run, ``python -m tinydiffusionmodels_torch.
dryrun N`` (the counterpart of ``__graft_entry__.dryrun_multichip``), as a
subprocess with a timeout: every section's line, each within 1e-5 of its
one-process step (the dry run raises otherwise), and the final
``[dryrun] OK on N devices``."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

SECTIONS = {
    4: ["mnist dp(4)", "text dp(2)xtp(2)", "ring attention sp(4)",
        "text sp(4) ring-attention", "text dp(2)xsp(2) ring-attention"],
    8: ["mnist dp(8)", "text dp(4)xtp(2)", "ring attention sp(8)",
        "text sp(8) ring-attention", "text dp(4)xsp(2) ring-attention"],
}


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_runs_every_section(n):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "tinydiffusionmodels_torch.dryrun", str(n),
         "--timeout", str(TIMEOUT_S - 30)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == f"[dryrun] OK on {n} devices"
    sections = lines[:-1]
    assert len(sections) == len(SECTIONS[n]), lines
    for line, name in zip(sections, SECTIONS[n]):
        assert line.startswith(f"[dryrun] {name}"), line
        err = float(re.search(r"max \|diff\| from one process (\S+)",
                              line).group(1))
        assert err <= 1e-5, line
