#!/usr/bin/env python3
"""Build the port's kernels and run only the training phases of
``chip_smoke.py`` on one card: 3t (the training kernels against their
plain versions), the device page accounting, 6b (a train step per
family, card against CPU), 6 (full-width qwen1.5-0.5b through the
driver), 6c (deepseek-moe-16b, 4 layers) and 6d (seamless-m4t-medium).
A short call for work on the training path; a failed ``ptxas`` spill
check is printed and the phases still run.

    python3 scripts/train_phases.py
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(build.build_all(), flush=True)
    try:
        C.check_ptxas(build.build_log)
    except AssertionError as err:
        print("check_ptxas failed:", err, flush=True)
    phases = (("3t", lambda: print(json.dumps(C.check_train_kernels(dev),
                                              default=str), flush=True)),
              ("pool", lambda: C.check_pool_state(dev)),
              ("6b", lambda: C.parity_train(dev)),
              ("6", C.train_full_width), ("6c", C.train_moe),
              ("6d", C.train_encdec))
    for name, run in phases:
        run()
        print(f"{name} done {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
