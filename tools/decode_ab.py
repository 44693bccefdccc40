"""The guided-decode kernel of other checkouts against this tree's, on the
card (an H100), in one process.

    git archive <rev> | tar -x -C build/parent    # any git-ignored directory
    python3 tools/decode_ab.py parent=build/parent [name=dir ...]

Each named checkout's ``tinydiffusionmodels_torch`` is copied to
``build/decode_ab/<name>/tdm_<name>`` with its imports renamed, so every
version loads beside this tree's and builds its own kernels. At the bench
shape (``chip_smoke``'s TinyGPT V 4096, D 256, depth 4, L 64, its weights and
logits), at batch 8 and 256, ten rounds alternate the order of the
versions; a round times each by CUDA events (``perf.device_ms``, 10
launches). Prints every run, the medians and quartiles, the rounds this
tree wins against each, and the rows whose tokens equal this tree's; every
line names the card and its power limit.
"""

from __future__ import annotations

import importlib
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "tinydiffusionmodels_torch"
ROUNDS = 10


def _copy(name: str, src: Path) -> str:
    """``src``'s package as ``tdm_<name>`` under build/decode_ab/<name>/."""
    pkg = f"tdm_{name}"
    dst = ROOT / "build" / "decode_ab" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src / PKG, dst / pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dst / pkg).rglob("*.py"):
        f.write_text(f.read_text().replace(PKG, pkg))
    sys.path.insert(0, str(dst))
    return pkg


def main(argv: list[str]) -> None:
    pairs = [a.split("=", 1) for a in argv]
    if not pairs or any(len(p) != 2 for p in pairs):
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as c
    from tinydiffusionmodels_torch import perf

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    pkgs = {"this": PKG}
    pkgs.update((name, _copy(name, Path(d).resolve())) for name, d in pairs)
    path = ":".join(sys.path)
    builds = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; sys.path[:0] = {path!r}.split(':'); "
         f"import {pkg}.ops._build as b; b.build()"]) for pkg in pkgs.values()]
    if any(p.wait() != 0 for p in builds):
        raise SystemExit("a version did not build")
    mods = {n: importlib.import_module(f"{pkg}.ops.decode_kernel")
            for n, pkg in pkgs.items()}
    model = c._tiny_gpt(4096, 4, seed=0)
    weights = {n: m.pack_weights(model) for n, m in mods.items()}
    kw = dict(alpha=c.ALPHA, temperature=1.0, normalize=False)
    for b in c.DECODE_BATCHES:
        g = torch.Generator(device="cuda").manual_seed(1)
        diff = torch.randn(b, c.SEQ, 4096, generator=g, device="cuda")
        fns = {n: (lambda m=m, w=weights[n]:
                   m.fused_guided_decode(w, diff, 0, **kw))
               for n, m in mods.items()}
        tokens = {n: f() for n, f in fns.items()}
        runs = {n: [] for n in mods}
        for i in range(ROUNDS):
            for n in (list(mods) if i % 2 == 0 else list(mods)[::-1]):
                runs[n].append(perf.device_ms(fns[n], iters=10, warmup=2))
        for n, t in runs.items():
            q = statistics.quantiles(t, n=4)
            same = int((tokens[n] == tokens["this"]).all(1).sum())
            print(f"bs {b} {n}: median {statistics.median(t):.4f} ms, "
                  f"quartiles {q[0]:.4f}-{q[2]:.4f}, runs "
                  f"{[round(x, 4) for x in t]}; rows equal to this tree's "
                  f"{same}/{b}; {card}", flush=True)
        for n in pkgs:
            if n != "this":
                wins = sum(a < o for a, o in zip(runs["this"], runs[n]))
                print(f"bs {b}: this tree faster than {n} in {wins}/{ROUNDS} "
                      f"rounds; {card}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
