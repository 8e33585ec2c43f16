"""Training launcher of the port: seeded weights -> fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 4 --ckpt build/train_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --steps 20 --batch 8 --seq 512 --ckpt build/train_ckpt

The JAX launcher's flags plus ``--device``. It builds the
``runtime.driver.TrainDriver`` directly (the reference's plan -> compile
facade is the planner's, ROADMAP A13; ``--xfer on|off`` raises for that
reason), with the reference's defaults (``api.Executable.train``): a
cosine schedule with ``max(steps // 20, 2)`` warm-up steps, params in
bf16 on the card and fp32 on the CPU, checkpoints kept 3 deep. The
driver restores from ``--ckpt`` when it holds a checkpoint: give a
fresh directory to start over. The port trains the dense family
(qwen1.5-0.5b by default; yi-9b, phi3-medium-14b, minitron-8b), the MoE
family (``--arch deepseek-moe-16b``) and the encdec family (``--arch
seamless-m4t-medium``, the pipeline's stub source frames encoded with
the tokens); the hybrid, ssm and vlm families raise (ROADMAP A12b). Runs
on the card by default.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.registry import build_train_step, init_params
from repro_torch.optim import adamw as OPT
from repro_torch.runtime.driver import DriverConfig, TrainDriver


def build_driver(arch, shape: ShapeConfig, *, steps: int, ckpt_dir,
                 ckpt_every: int = 10, keep: int = 3,
                 opt_cfg: OPT.AdamWConfig = None, accum_steps: int = 1,
                 seed: int = 0, device=None, dtype=None) -> TrainDriver:
    """The driver ``main`` runs, as ``api.Executable.train`` builds the
    reference's: seeded params, zero AdamW state, the cosine schedule,
    the pipeline over (arch, shape) and a checkpointer."""
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    model = init_params(arch, seed, device=device, dtype=dtype)
    opt_state = OPT.adamw_init(model, opt_cfg)
    schedule = OPT.cosine_schedule(opt_cfg.lr, warmup=max(steps // 20, 2),
                                   total=steps)
    step_fn = build_train_step(arch, opt_cfg, schedule, accum_steps)
    return TrainDriver(step_fn, model, opt_state,
                       TokenPipeline(arch, shape, seed=seed),
                       Checkpointer(ckpt_dir, keep=keep),
                       DriverConfig(total_steps=steps,
                                    checkpoint_every=ckpt_every, keep=keep))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory (restored from when it holds "
                         "a checkpoint)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--xfer", choices=("on", "off", "auto"), default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.xfer != "auto":
        raise NotImplementedError("--xfer on|off picks a sharding plan: the "
                                  "planner is not ported yet (ROADMAP A13)")

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    driver = build_driver(arch, shape, steps=args.steps, ckpt_dir=args.ckpt,
                          ckpt_every=args.ckpt_every,
                          opt_cfg=OPT.AdamWConfig(lr=args.lr),
                          seed=args.seed, device=args.device)
    model = driver.params
    print(f"[train] {arch.name} on {model.device} ({model.dtype}), batch "
          f"{args.batch} x seq {args.seq}, {args.steps} steps, ckpt "
          f"{args.ckpt}")
    t0 = time.time()
    result = driver.run()
    dt = time.time() - t0
    losses = [m["loss"] for m in result["log"]]
    print(f"[train] {len(losses)} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1) * 1e3:.1f} ms/step) "
          + (f"loss {losses[0]:.4f} -> {losses[-1]:.4f} " if losses else "")
          + f"restarts={result['restarts']} "
          f"stragglers={result['straggler_events']}")
    if losses and not np.isfinite(losses[-1]):
        raise RuntimeError(f"non-finite final loss {losses[-1]}")
    return result


if __name__ == "__main__":
    main()
