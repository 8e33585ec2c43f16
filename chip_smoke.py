#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure propagates; the process exits non-zero):

1. card identity: ``nvidia-smi`` name and power limit, TF32 off;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes plus one ragged case each, in fp32 (tolerance
   1e-3: summation order) and bf16 (5e-2, the tests/test_kernels.py bf16
   tolerance); kernel, plain-version and one-PyTorch-call (yardstick
   only) times with CUDA events;
4. full-width qwen1.5-0.5b served greedily in bf16 through
   ``ServingEngine.run_until_drained()``: every kernel's launch counter
   must rise on that run;
5. full-width parity: seeded fp32 weights, one batched prefill of 4
   prompts plus 4 greedy decode steps on the card vs on the CPU (plain
   versions): last-position logits within 2e-3 of max |logit|, greedy
   tokens equal;
6. the kernel table as one JSON line, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off tensor cores
TOL = {"float32": 1e-3, "bfloat16": 5e-2}

# serving-path geometry of full-width qwen1.5-0.5b in this run
SLOTS, MAX_LEN, BUCKET, N_PREFILL = 8, 512, 256, 8
SOURCES = {
    "xfer_matmul": ("src/repro_torch/kernels/csrc/xfer_matmul.cu",
                    "src/repro/kernels/xfer_matmul.py:22"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:74"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, dtype: str) -> float:
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {max_err:.3e}, tol {tol})")
    return max_err


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

def check_kernels(dev) -> dict:
    """Returns the timed entry per kernel (the serving path's dominant shape,
    bf16) and prints every case."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries = {}

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    # ---- xfer_matmul: every projection + the tied unembedding (embed.T)
    d, ff, vocab = 1024, 2816, 151936
    mm_cases = []
    for r in (SLOTS, N_PREFILL * BUCKET):
        for n, m in ((d, d), (d, ff), (ff, d)):
            mm_cases.append((f"R={r} {n}x{m}", r, n, m, False))
    # the unembedding runs at R = slots (decode) and R = group size (prefill)
    mm_cases.append((f"R={SLOTS} {d}x{vocab} (embed.T)", SLOTS, d, vocab, True))
    mm_cases.append(("ragged R=13 1000x1001", 13, 1000, 1001, False))
    mm_cases.append(("ragged R=77 1000x1001 (w.T)", 77, 1000, 1001, True))
    for dname, dt in dtypes.items():
        for label, r, n, m, transposed in mm_cases:
            x = randn(r, n, dt=dt)
            if transposed:
                w = randn(m, n, dt=dt, scale=n ** -0.5).T  # strided view
            else:
                w = randn(n, m, dt=dt, scale=n ** -0.5)
            got = ops.matmul(x, w)
            err = compare(f"xfer_matmul {label} {dname}", got,
                          ops.matmul_ref(x, w), dname)
            line = f"[kernel] xfer_matmul {label} {dname}: max_abs_err {err:.3e}"
            if dname == "bfloat16" and not label.startswith("ragged"):
                ms = time_ms(lambda: ops.matmul(x, w))
                plain = time_ms(lambda: ops.matmul_ref(x, w))
                lib = time_ms(lambda: torch.matmul(x, w))
                esz = x.element_size()
                b, kind = bound_ms((r * n + n * m + r * m) * esz,
                                   2.0 * r * n * m, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f} bound_ms {b:.4f} ({kind})")
                if r == SLOTS and m == vocab:
                    entries["xfer_matmul"] = dict(
                        shape=f"x[{r},{n}] @ embed.T[{n},{m}] bf16",
                        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=kind, library_ms=lib)
            log(line)
        del x, w, got

    # ---- flash_attention: prefill self-attention, q/k/v [n*16, bucket, 64]
    fa_cases = [(f"BH={N_PREFILL * 16} S={BUCKET}", N_PREFILL * 16, BUCKET, 0, True),
                ("BH=32 S=64", 32, 64, 0, True),
                ("BH=16 S=16", 16, 16, 0, True),
                ("ragged BH=6 S=100", 6, 100, 0, True),
                ("window BH=6 S=200 w=48", 6, 200, 48, True),
                ("non-causal BH=4 S=96", 4, 96, 0, False)]
    for dname, dt in dtypes.items():
        for label, bh, s, window, causal in fa_cases:
            q, k, v = (randn(bh, s, 64, dt=dt) for _ in range(3))
            got = ops.attention(q, k, v, causal=causal, window=window)
            want = ops.attention_ref(q, k, v, causal=causal, window=window)
            err = compare(f"flash_attention {label} {dname}", got, want, dname)
            line = f"[kernel] flash_attention {label} {dname}: max_abs_err {err:.3e}"
            if dname == "bfloat16" and label.startswith("BH="):
                ms = time_ms(lambda: ops.attention(q, k, v))
                plain = time_ms(lambda: ops.attention_ref(q, k, v))
                q4, k4, v4 = (t[None] for t in (q, k, v))
                lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True))
                pairs = bh * s * (s + 1) / 2  # causal: visible pairs only
                b, kind = bound_ms(4 * bh * s * 64 * q.element_size(),
                                   4.0 * 64 * pairs, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f} bound_ms {b:.4f} ({kind})")
                if bh == N_PREFILL * 16:
                    entries["flash_attention"] = dict(
                        shape=f"q,k,v[{bh},{s},64] causal bf16",
                        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=kind, library_ms=lib)
            log(line)

    # ---- paged_attention: decode over the dense slot grid (identity table)
    lengths_main = [1, 17, 64, 128, 129, 200, 233, MAX_LEN]
    for dname, dt in dtypes.items():
        cases = []
        kp = randn(SLOTS, MAX_LEN, 16, 64, dt=dt)
        vp = randn(SLOTS, MAX_LEN, 16, 64, dt=dt)
        table = torch.arange(SLOTS, device=dev, dtype=torch.int32)[:, None]
        cases.append((f"grid q[{SLOTS},16,64] pool[{SLOTS},{MAX_LEN},16,64]",
                      randn(SLOTS, 16, 64, dt=dt), kp, vp, table,
                      torch.tensor(lengths_main, device=dev, dtype=torch.int32)))
        # ragged: GQA 8 heads over 2 groups, 16-token pages, permuted table
        n_pages, ps, m = 3 * 9 + 2, 16, 9
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        cases.append(("ragged GQA H=8 G=2 ps=16",
                      randn(3, 8, 64, dt=dt), randn(n_pages, ps, 2, 64, dt=dt),
                      randn(n_pages, ps, 2, 64, dt=dt),
                      perm[:3 * m].reshape(3, m).to(torch.int32),
                      torch.tensor([1, 77, m * ps], device=dev, dtype=torch.int32)))
        for label, q, kp_, vp_, tb, lens in cases:
            got = ops.paged_attn(q, kp_, vp_, tb, lens)
            want = ops.paged_attn_ref(q, kp_, vp_, tb, lens)
            err = compare(f"paged_attention {label} {dname}", got, want, dname)
            line = f"[kernel] paged_attention {label} {dname}: max_abs_err {err:.3e}"
            if dname == "bfloat16" and label.startswith("grid"):
                ms = time_ms(lambda: ops.paged_attn(q, kp_, vp_, tb, lens))
                plain = time_ms(lambda: ops.paged_attn_ref(q, kp_, vp_, tb, lens))
                # yardstick: SDPA over the same grid with a length mask
                q4 = q[:, :, None, :]                       # [B, H, 1, D]
                k4 = kp_.permute(0, 2, 1, 3)                # [B, G, T, D]
                v4 = vp_.permute(0, 2, 1, 3)
                mask = (torch.arange(MAX_LEN, device=dev)[None] < lens[:, None])
                mask = mask[:, None, None, :]
                lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask))
                tokens = sum(lengths_main)
                esz = q.element_size()
                nbytes = (2 * q.numel() * esz + 2 * tokens * 16 * 64 * esz
                          + tb.numel() * 4 + lens.numel() * 4)
                b, kind = bound_ms(nbytes, 4.0 * 16 * 64 * tokens, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f} bound_ms {b:.4f} ({kind})")
                entries["paged_attention"] = dict(
                    shape=f"q[{SLOTS},16,64] grid[{SLOTS},{MAX_LEN},16,64] "
                          f"lengths {lengths_main} bf16",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=kind, library_ms=lib)
            log(line)
    return entries


# --------------------------------------------------------------------------
# phase 4: full-width serving through the kernels
# --------------------------------------------------------------------------

def serve_full_width() -> dict:
    """Serves 16 requests through full-width qwen1.5-0.5b in bf16 and
    returns the kernels' launch counts over that run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    arch = get_arch("qwen1.5-0.5b")
    n_req, new_tokens = 16, 32
    config = ServeConfig(slots=SLOTS, max_len=MAX_LEN, seed=0, lookahead=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(arch, config.seed)  # on the card, bf16
    engine = ServingEngine(arch, model, config=config)
    torch.cuda.synchronize()
    log(f"[serve] {arch.name}: {arch.num_layers} layers, d {arch.d_model}, "
        f"{model.dtype}, params + grid ready in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    lens = []
    for rid in range(n_req):
        s = int(rng.randint(16, 201))
        lens.append(s)
        engine.submit(Request(rid=rid, prompt=rng.randint(
            1, arch.vocab_size, size=s).astype(np.int32), max_new_tokens=new_tokens))
    log(f"[serve] prompt lengths {lens}")

    ops.reset_launches()
    t0 = time.perf_counter()
    steps = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    done = sorted(engine.completed, key=lambda r: r.rid)
    if len(done) != n_req:
        raise AssertionError(f"{len(done)}/{n_req} requests completed")
    for r in done:
        if len(r.out_tokens) != new_tokens or not all(
                0 <= t < arch.vocab_size for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: bad stream {r.out_tokens}")
    log(f"[serve] {n_req}/{n_req} requests, {steps} decode steps, "
        f"{wall:.3f} s wall; launches {counts}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the serving path")
    per_step = 7 * arch.num_layers + 1
    if counts["xfer_matmul"] < per_step * steps:
        raise AssertionError(f"xfer_matmul launched {counts['xfer_matmul']} "
                             f"times, under {per_step} x {steps} decode steps")
    log(f"[serve] step_stats {json.dumps(engine.step_stats())}")
    log(f"[serve] prefill_stats {json.dumps(engine.prefill_stats())}")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kv_bytes = sum(c[k].numel() * c[k].element_size()
                   for c in engine.caches for k in ("k", "v"))
    log(f"[serve] weight_bytes {weight_bytes} kv_bytes {kv_bytes} "
        f"peak_allocated_bytes {torch.cuda.max_memory_allocated()}")
    log(f"[serve] rid=0 out={done[0].out_tokens[:8]}")
    del engine, model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 5: full-width parity, card vs CPU
# --------------------------------------------------------------------------

PARITY_TOL = 2e-3  # max |logits_card - logits_cpu| / max |logits_cpu|


def parity_full_width(dev) -> None:
    """Seeded fp32 weights; a batched bucketed prefill of 4 prompts and 4
    greedy decode steps on the card and on the CPU, fed the same tokens
    (the CPU's greedy choices)."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.scheduler import prefill_rows, splice_rows

    arch = get_arch("qwen1.5-0.5b")
    t0 = time.perf_counter()
    cpu_model = init_params(arch, 1, device="cpu")  # fp32
    card_model = copy.deepcopy(cpu_model).to(dev)
    log(f"[parity] fp32 weights on CPU and card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(1)
    lens = np.array([37, 64, 50, 21], np.int32)
    n, bucket, cache_len, steps = 4, 64, 128, 4
    toks = np.zeros((n, bucket), np.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = rng.randint(1, arch.vocab_size, size=s)

    def run(model, feed=None):
        d = model.device
        rows, logits = prefill_rows(model, torch.from_numpy(toks).to(d),
                                    torch.from_numpy(lens).to(d))
        grid = model.make_caches(n, cache_len)
        splice_rows(grid, rows, torch.arange(n, device=d))
        out = [logits[:, -1].float().cpu()]
        chosen = [out[-1].argmax(-1).to(torch.int32)]
        pos = torch.from_numpy(lens).to(d)[:, None]
        for j in range(steps):
            tok = (feed[j] if feed is not None else chosen[-1]).to(d)[:, None]
            hidden, grid = model(tok, caches=grid, positions=pos)
            out.append(model.logits(hidden)[:, -1].float().cpu())
            chosen.append(out[-1].argmax(-1).to(torch.int32))
            pos = pos + 1
        return out, chosen

    t0 = time.perf_counter()
    with torch.no_grad():
        want, want_tok = run(cpu_model)
        got, got_tok = run(card_model, feed=want_tok)
    log(f"[parity] prefill + {steps} decode steps on both in "
        f"{time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        rel = float((g - w).abs().max()) / scale
        worst = max(worst, rel)
        flips = (got_tok[j] != want_tok[j]).nonzero().flatten().tolist()
        line = f"[parity] position {j}: max rel err {rel:.3e}"
        for b in flips:
            top = torch.topk(w[b], 2).values
            margin = float(top[0] - top[1]) / scale
            line += f"; row {b} flips with top-2 margin {margin:.3e}"
            if margin > PARITY_TOL:
                raise AssertionError(f"greedy token differs at position {j} row "
                                     f"{b} with margin {margin:.3e} > {PARITY_TOL}")
        log(line)
    if worst > PARITY_TOL:
        raise AssertionError(f"card vs CPU logits: rel err {worst:.3e} > {PARITY_TOL}")
    log(f"[parity] ok: worst rel err {worst:.3e} (tolerance {PARITY_TOL})")
    del card_model
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops

    # ---- phase 1: card identity
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- phase 2: build
    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"[build] {len(seconds)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s: {seconds}")
    for name, out in build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[ptxas] {name}: {line.strip()}")

    # ---- phase 3: kernels vs plain versions
    entries = check_kernels(dev)

    # ---- phase 4: the serving path, with the launch counters read around it
    counts = serve_full_width()

    # ---- phase 5: card vs CPU at full width
    parity_full_width(dev)

    kernels = []
    for k in ops.KERNELS:
        e = entries[k.__name__]
        src, replaces = SOURCES[k.__name__]
        kernels.append({"name": k.__name__, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[k.__name__],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"],
                        "library_ms": e["library_ms"], "shape": e["shape"]})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
