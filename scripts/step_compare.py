#!/usr/bin/env python3
"""Decode-step and admission times of the port's serving paths on one card,
for one or more checkouts of the repository, in the order given.

    python3 scripts/step_compare.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
For each, in a fresh process, it runs that checkout's own
``chip_smoke.py`` serving phases: 4 (qwen1.5-0.5b, bf16), 4c
(recurrentgemma-2b) and 4d (xlstm-350m), kernels built from that
checkout's sources. It prints one JSON line per tree and phase with the
``step_stats`` and ``prefill_stats`` that the phase logged. Give the trees
as parent, change, change, parent to see the spread between calls of one
tree beside the difference between trees. It needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_DRIVE = """
import sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
build.build_all()
cs.serve_full_width()
cs.serve_hybrid()
cs.serve_xlstm()
"""
_TAGS = {"serve": "4", "serve-hybrid": "4c", "serve-ssm": "4d"}


def run_tree(tree: str) -> list:
    root = os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", _DRIVE.format(root=root)],
                          cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rows = {}
    for line in proc.stdout.splitlines():
        for kind in ("step_stats", "prefill_stats"):
            marker = f"] {kind} "
            if line.startswith("[") and marker in line:
                tag = line[1:line.index("]")]
                if tag in _TAGS:
                    rows.setdefault(tag, {})[kind] = json.loads(
                        line.split(marker, 1)[1])
    return [dict(tree=tree, phase=_TAGS[tag], **stats)
            for tag, stats in rows.items()]


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
