#!/bin/bash
# The port's bench (python -m tinydiffusionmodels_torch.bench) for two
# trees on one card, in turns: the parent tree in build/parent (e.g.
# `git archive <rev> | tar -x -C build/parent`) and this checkout, in the
# order ORDER (default "parent change change parent"). Builds both trees'
# kernels first, prints the card's name and power limit, then one line per
# run: the side and the bench's JSON line; each run's whole output goes to
# $OUT/bench_<i>_<side>.log (OUT default build/bench_ab). On the card, from
# the root of the checkout:
#   bash tinydiffusionmodels_torch/bench_ab.sh
parent=build/parent
out=${OUT:-build/bench_ab}
mkdir -p "$out"
python3 -c "from tinydiffusionmodels_torch.ops import _build; _build.library()" || exit 1
(cd "$parent" && python3 -c "from tinydiffusionmodels_torch.ops import _build; _build.library()") || exit 1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for side in ${ORDER:-parent change change parent}; do
  i=$((i+1))
  if [ "$side" = parent ]; then dir=$parent; else dir=.; fi
  log="$(pwd)/$out/bench_${i}_${side}.log"
  (cd "$dir" && python3 -m tinydiffusionmodels_torch.bench) > "$log" 2>&1 || exit 1
  echo "$side $(tail -n 1 "$log")"
done
