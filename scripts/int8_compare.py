#!/usr/bin/env python3
"""Times of the INT8 kernels on one card, for one or more checkouts of the
repository, in the order given.

    python3 scripts/int8_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
For each, in a fresh process, it builds that checkout's kernels and runs
its own ``chip_smoke.py`` INT8 kernel checks (``check_int8_kernels``:
``quant_matmul`` at every INT8 serving shape, the int8 ``paged_attention``
body), each kernel against its plain version. It prints one JSON line per
tree and timed case: the case's label and its kernel, plain-version and
library times. Give the trees as parent, change, change, parent to see
the spread between calls of one tree beside the difference between
trees. It needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

_DRIVE = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
build.build_all()
cs.check_int8_kernels(dev, torch.Generator(device=dev).manual_seed(0))
"""
_LINE = re.compile(r"\[kernel\] (\S+) (.+?) float32: .* ms ([0-9.]+) plain_ms "
                   r"([0-9.]+)(?: library_ms ([0-9.]+))?")


def run_tree(tree: str) -> list:
    root = os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", _DRIVE.format(root=root)],
                          cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rows = []
    for line in proc.stdout.splitlines():
        m = _LINE.search(line)
        if m:
            kernel, case, ms, plain, lib = m.groups()
            rows.append(dict(tree=tree, kernel=kernel, case=case,
                             ms=float(ms), plain_ms=float(plain),
                             library_ms=float(lib) if lib else None))
    return rows


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in argv[1:]:
        for row in run_tree(tree):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
