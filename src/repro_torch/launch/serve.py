"""Serving launcher of the port: random seeded weights -> serving.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --requests 16 --slots 8 --max-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --full --requests 16 --slots 8 --max-len 2560
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --temperature 0.7 --top-k 20

Greedy by default; ``--temperature`` samples from softmax(logits / T),
``--top-k`` over the k largest logits only (temperature 1.0 unless
given), each request with the key ``fold_in(PRNGKey(--seed), rid)``, as
the JAX launcher does. Like the JAX launcher it has no flag for
speculative decoding (``ServeConfig(spec=...)`` in code).

Every registered ``--arch`` is accepted, and the requests are token
prompts only, as the JAX launcher's are: paligemma-3b serves them
text-only, and seamless-m4t-medium refuses the first at ``submit`` with
the reference's ``ValueError`` (an encdec request needs source frames;
``Request(src_frames=...)`` in code).

Builds ``ServingEngine(arch, params, config=ServeConfig(...))`` directly
(the JAX launcher's plan -> compile facade and its ``--xfer`` switch are
not ported yet). Runs on the card by default; ``--device cpu`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models.registry import init_params
from repro_torch.serving import (Request, SamplingParams, ServeConfig,
                                 ServingEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    # on-device sampling knobs (greedy when neither is set)
    ap.add_argument("--temperature", type=float, default=None,
                    help="sample instead of greedy decode (default 1.0 "
                         "when only --top-k is given)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k largest logits")
    ap.add_argument("--lookahead", type=int, default=1,
                    help="dispatch depth (1 = double-buffered, 0 = sync)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    sampling = None
    if args.temperature is not None or args.top_k:
        sampling = SamplingParams(
            method="top_k" if args.top_k else "temperature",
            temperature=1.0 if args.temperature is None else args.temperature,
            top_k=args.top_k)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    config = ServeConfig(slots=args.slots, max_len=args.max_len,
                         seed=args.seed, sampling=sampling,
                         lookahead=args.lookahead)
    params = init_params(arch, config.seed, device=args.device)
    engine = ServingEngine(arch, params, config=config, device=args.device)
    print(f"[serve] {arch.name} on {engine.device} ({params.dtype}), "
          f"slots={args.slots} max_len={args.max_len}, "
          f"sampling {engine.sampling}")

    rng = np.random.RandomState(0)
    for i in range(args.requests):
        prompt = rng.randint(1, arch.vocab_size,
                             size=rng.randint(4, 17)).astype(np.int32)
        engine.submit(Request(rid=i, prompt=prompt,
                              max_new_tokens=args.new_tokens))

    t0 = time.time()
    steps = engine.run_until_drained()
    dt = time.time() - t0
    lat = [r.finished_at - r.submitted_at for r in engine.completed]
    stats = engine.step_stats()
    print(f"[serve] {len(engine.completed)}/{args.requests} requests in "
          f"{steps} steps, {dt:.2f}s wall; mean latency "
          f"{np.mean(lat) * 1e3:.1f}ms, p99 {np.percentile(lat, 99) * 1e3:.1f}ms; "
          f"step p50 {stats['step_p50_ms']:.2f}ms, "
          f"{stats['tokens_per_s']:.0f} tok/s")
    for r in engine.completed[:3]:
        print(f"  rid={r.rid} out={r.out_tokens[:8]}")
    if len(engine.completed) != args.requests:
        raise RuntimeError(f"{len(engine.completed)}/{args.requests} "
                           f"requests completed")
    return engine


if __name__ == "__main__":
    main()
