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
   only) times with CUDA events. The INT8 kernels (``quant_matmul``, the int8 body of
   ``paged_attention``) are checked the same way, with q/x in fp32
   (the INT8 path's activations) and bf16. ``quant_matmul``'s library
   call is ``torch._weight_int8pack_mm`` on the weight transposed ahead
   of time (or the error it raises); no PyTorch call computes the int8
   attention body. Their labelled yardsticks are ``torch.matmul`` on a
   weight dequantised ahead of time and SDPA over pre-dequantised K/V;
4. full-width qwen1.5-0.5b served greedily in bf16 through
   ``ServingEngine.run_until_drained()``: the fp kernels' launch
   counters must rise by their per-step counts, the INT8 ones stay 0;
4b. the same traffic under ``ServeConfig(quant=INT8_SERVE)``:
   ``quant_matmul`` rises by 169 x (decode steps + prefill groups), the
   int8 ``paged_attention`` by 24 x steps, ``flash_attention`` by 24 x
   groups, ``xfer_matmul`` and the fp ``paged_attention`` by 0;
5. full-width parity: seeded fp32 weights, one batched prefill of 4
   prompts plus 4 greedy decode steps on the card vs on the CPU (plain
   versions): last-position logits within 2e-3 of max |logit|, greedy
   tokens equal (a flip is allowed only under a top-2 margin of 2e-3);
5b. the same under INT8: the same fp32 weights quantised on the card
   and on the CPU give bit-equal int8 payloads and scales; then the same
   prefill and decode steps over int8 grids, held to the same
   tolerance (a K/V value one int8 level apart on the two sides is
   inside it);
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
    "paged_attention_q8": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:81"),
    "quant_matmul": ("src/repro_torch/kernels/csrc/xfer_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:27"),
}
# the kernels each serving path runs (phase 4: fp, phase 4b: INT8)
PATH_KERNELS = {"fp": ("xfer_matmul", "flash_attention", "paged_attention"),
                "int8": ("quant_matmul", "flash_attention",
                         "paged_attention_q8")}


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
    entries.update(check_int8_kernels(dev, gen))
    return entries


def int8pack_ms(x, w_q, scale, want):
    """``torch._weight_int8pack_mm(x, w [M, N] int8, scales [M])``, the
    PyTorch call that computes ``quant_matmul``, with the weight
    transposed ahead of time (no copy for the unembedding's ``q.T``).
    Returns (ms, max abs err against the plain version), or (None, the
    first line of the error it raises)."""
    import torch
    w_t, s = w_q.T.contiguous(), scale.reshape(-1).to(x.dtype)
    try:
        out = torch._weight_int8pack_mm(x, w_t, s)
    except (RuntimeError, NotImplementedError) as e:
        return None, str(e).strip().splitlines()[0]
    err = float((out.float() - want.float()).abs().max())
    return time_ms(lambda: torch._weight_int8pack_mm(x, w_t, s)), err


def check_int8_kernels(dev, gen) -> dict:
    """``quant_matmul`` and the int8 ``paged_attention`` body against
    their plain versions; timed in fp32, the INT8 path's activations."""
    import torch
    from repro_torch import quant as Q
    from repro_torch.kernels import ops

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries = {}

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    # ---- quant_matmul: every projection + the tied unembedding (q.T)
    d, ff, vocab = 1024, 2816, 151936
    cases = []
    for r in (SLOTS, N_PREFILL * BUCKET):
        for n, m in ((d, d), (d, ff), (ff, d)):
            cases.append((f"R={r} {n}x{m}", r, n, m, False))
    cases.append((f"R={SLOTS} {d}x{vocab} (embed.q.T)", SLOTS, d, vocab, True))
    cases.append(("ragged R=13 1000x1001", 13, 1000, 1001, False))
    cases.append(("ragged R=77 1000x1001 (q.T)", 77, 1000, 1001, True))
    for label, r, n, m, transposed in cases:
        if transposed:  # the unembedding: unit scale, q.T a strided view
            w = Q.quantize(randn(m, n, scale=n ** -0.5), axis=0)
            w_q, scale = w.q.T, torch.ones(1, m, device=dev)
        else:
            w = Q.quantize(randn(n, m, scale=n ** -0.5), axis=0)
            w_q, scale = w.q, w.scale
        w_deq = Q.dequantize(Q.QTensor(w_q, scale))
        for dname, dt in dtypes.items():
            x = randn(r, n, dt=dt)
            got = ops.int8_matmul(x, w_q, scale)
            want = ops.int8_matmul_ref(x, w_q, scale)
            err = compare(f"quant_matmul {label} {dname}", got, want, dname)
            line = f"[kernel] quant_matmul {label} {dname}: max_abs_err {err:.3e}"
            if dname == "float32" and not label.startswith("ragged"):
                ms = time_ms(lambda: ops.int8_matmul(x, w_q, scale))
                plain = time_ms(lambda: ops.int8_matmul_ref(x, w_q, scale))
                lib, lib_note = int8pack_ms(x, w_q, scale, want)
                yard = time_ms(lambda: torch.matmul(x, w_deq))
                b, kind = bound_ms(r * n * 4 + n * m + m * 4 + r * m * 4,
                                   2.0 * r * n * m, dname)
                lib_text = (f"{lib:.4f} (torch._weight_int8pack_mm, max_abs_err "
                            f"{lib_note:.3e})" if lib is not None else
                            f"null (torch._weight_int8pack_mm raises: {lib_note})")
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib_text} yardstick_ms {yard:.4f} (torch.matmul on "
                         f"a weight dequantised ahead of time) bound_ms "
                         f"{b:.4f} ({kind})")
                if r == SLOTS and m == vocab:
                    entries["quant_matmul"] = dict(
                        shape=f"x[{r},{n}] fp32 @ embed.q.T[{n},{m}] int8",
                        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=kind, library_ms=lib, yardstick_ms=yard,
                        yardstick="torch.matmul on the pre-dequantised weight")
                    if lib is None:
                        entries["quant_matmul"]["library_error"] = lib_note
            log(line)
        del x, got, want, w, w_q, w_deq

    # ---- paged_attention int8 body: decode over the int8 slot grid
    lengths_main = [1, 17, 64, 128, 129, 200, 233, MAX_LEN]
    kq = Q.quantize_kv(randn(SLOTS, MAX_LEN, 16, 64))
    vq = Q.quantize_kv(randn(SLOTS, MAX_LEN, 16, 64))
    table = torch.arange(SLOTS, device=dev, dtype=torch.int32)[:, None]
    lens_main = torch.tensor(lengths_main, device=dev, dtype=torch.int32)
    n_pages, ps, m = 3 * 9 + 2, 16, 9
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    rk = Q.quantize_kv(randn(n_pages, ps, 2, 64))
    rv = Q.quantize_kv(randn(n_pages, ps, 2, 64))
    for dname, dt in dtypes.items():
        cases = [(f"grid q[{SLOTS},16,64] int8 pool[{SLOTS},{MAX_LEN},16,64]",
                  randn(SLOTS, 16, 64, dt=dt), kq, vq, table, lens_main),
                 ("ragged GQA H=8 G=2 ps=16", randn(3, 8, 64, dt=dt), rk, rv,
                  perm[:3 * m].reshape(3, m).to(torch.int32),
                  torch.tensor([1, 77, m * ps], device=dev, dtype=torch.int32))]
        for label, q, k8, v8, tb, lens in cases:
            args = (q, k8.q, v8.q, tb, lens)
            scales = dict(k_scale=k8.scale, v_scale=v8.scale)
            got = ops.paged_attn(*args, **scales)
            want = ops.paged_attn_ref(*args, **scales)
            err = compare(f"paged_attention_q8 {label} {dname}", got, want, dname)
            line = f"[kernel] paged_attention_q8 {label} {dname}: max_abs_err {err:.3e}"
            if dname == "float32" and label.startswith("grid"):
                ms = time_ms(lambda: ops.paged_attn(*args, **scales))
                plain = time_ms(lambda: ops.paged_attn_ref(*args, **scales))
                # yardstick: SDPA over K/V dequantised ahead of time
                q4 = q[:, :, None, :]
                k4 = Q.dequantize(k8).permute(0, 2, 1, 3)
                v4 = Q.dequantize(v8).permute(0, 2, 1, 3)
                mask = (torch.arange(MAX_LEN, device=dev)[None] < lens[:, None])
                mask = mask[:, None, None, :]
                yard = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask))
                tokens = sum(lengths_main)
                nbytes = (2 * q.numel() * 4 + tokens * 16 * (2 * 64 + 2 * 4)
                          + tb.numel() * 4 + lens.numel() * 4)
                b, kind = bound_ms(nbytes, 4.0 * 16 * 64 * tokens, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} yardstick_ms "
                         f"{yard:.4f} (SDPA over pre-dequantised K/V, masked) "
                         f"bound_ms {b:.4f} ({kind})")
                entries["paged_attention_q8"] = dict(
                    shape=f"q[{SLOTS},16,64] fp32 int8 grid[{SLOTS},{MAX_LEN},16,64] "
                          f"lengths {lengths_main}",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=kind, library_ms=None, yardstick_ms=yard,
                    yardstick="SDPA over pre-dequantised K/V")
            log(line)
    return entries


# --------------------------------------------------------------------------
# phase 4: full-width serving through the kernels
# --------------------------------------------------------------------------

def serve_full_width(int8: bool = False) -> dict:
    """Serves 16 requests through full-width qwen1.5-0.5b (bf16 engine;
    ``ServeConfig(quant=INT8_SERVE)`` when ``int8``) and returns the
    kernels' launch counts over that run, after checking them against
    the path's per-step counts."""
    import numpy as np
    import torch
    from repro_torch import quant as Q
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    tag = "serve-int8" if int8 else "serve"
    arch = get_arch("qwen1.5-0.5b")
    n_req, new_tokens = 16, 32
    config = ServeConfig(slots=SLOTS, max_len=MAX_LEN, seed=0, lookahead=1,
                         quant=Q.INT8_SERVE if int8 else Q.QuantConfig())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(arch, config.seed)  # on the card, bf16
    engine = ServingEngine(arch, model, config=config)
    torch.cuda.synchronize()
    log(f"[{tag}] {arch.name}: {arch.num_layers} layers, d {arch.d_model}, "
        f"{model.dtype}, quant {config.quant}, params + grid ready in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    lens = []
    for rid in range(n_req):
        s = int(rng.randint(16, 201))
        lens.append(s)
        engine.submit(Request(rid=rid, prompt=rng.randint(
            1, arch.vocab_size, size=s).astype(np.int32), max_new_tokens=new_tokens))
    log(f"[{tag}] prompt lengths {lens}")

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
    pstats = engine.prefill_stats()
    groups = int(pstats["prefill_dispatches"])
    log(f"[{tag}] {n_req}/{n_req} requests, {steps} decode steps, {groups} "
        f"prefill groups, {wall:.3f} s wall; launches {counts}")
    path = PATH_KERNELS["int8" if int8 else "fp"]
    for name, n in counts.items():
        if (n == 0) == (name in path):
            raise AssertionError(f"{name} launched {n} times on the "
                                 f"{tag} path, which runs {path}")
    per_pass = 7 * arch.num_layers + 1  # projections + the unembedding
    if int8:
        want = {"quant_matmul": per_pass * (steps + groups),
                "paged_attention_q8": arch.num_layers * steps,
                "flash_attention": arch.num_layers * groups}
        for name, n in want.items():
            if counts[name] != n:
                raise AssertionError(f"{name} launched {counts[name]} times, "
                                     f"expected {n} ({steps} decode steps, "
                                     f"{groups} prefill groups)")
    elif counts["xfer_matmul"] < per_pass * steps:
        raise AssertionError(f"xfer_matmul launched {counts['xfer_matmul']} "
                             f"times, under {per_pass} x {steps} decode steps")
    log(f"[{tag}] step_stats {json.dumps(engine.step_stats())}")
    log(f"[{tag}] prefill_stats {json.dumps(pstats)}")
    leaves = Q.named_leaves(model).values()
    int8_bytes = sum(v.q.numel() for v in leaves if Q.is_qtensor(v))
    kv = {name: sum(c[name].numel() * c[name].element_size()
                    for c in engine.caches)
          for name in engine.caches[0] if name != "pos"}
    log(f"[{tag}] weight_bytes {Q.leaf_bytes(model)} (int8 payload "
        f"{int8_bytes}) kv_bytes {kv} peak_allocated_bytes "
        f"{torch.cuda.max_memory_allocated()}")
    log(f"[{tag}] rid=0 out={done[0].out_tokens[:8]}")
    del engine, model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 5: full-width parity, card vs CPU
# --------------------------------------------------------------------------

PARITY_TOL = 2e-3  # max |logits_card - logits_cpu| / max |logits_cpu|


def parity_full_width(dev) -> None:
    """Phase 5, then 5b: seeded fp32 weights on the card and on the CPU,
    fp, then quantised on each side (int8 payloads and scales must be
    bit-equal) and served over int8 grids."""
    import copy

    import torch
    from repro_torch import quant as Q
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params

    arch = get_arch("qwen1.5-0.5b")
    t0 = time.perf_counter()
    cpu_model = init_params(arch, 1, device="cpu")  # fp32
    card_model = copy.deepcopy(cpu_model).to(dev)
    log(f"[parity] fp32 weights on CPU and card in {time.perf_counter() - t0:.1f} s")
    compare_card_cpu(arch, cpu_model, card_model, "parity", kv_quant=False)

    t0 = time.perf_counter()
    cpu_q = Q.quantize_params(copy.deepcopy(cpu_model))
    del cpu_model
    card_q = Q.quantize_params(card_model)
    torch.cuda.synchronize()
    want, got = Q.named_leaves(cpu_q), Q.named_leaves(card_q)
    if set(want) != set(got):
        raise AssertionError(f"quantised leaves differ: {sorted(set(want) ^ set(got))}")
    n_q = 0
    for name, w in want.items():
        g = got[name]
        for part, a, b in ((("q", w.q, g.q), ("scale", w.scale, g.scale))
                           if Q.is_qtensor(w) else (("fp", w, g),)):
            b = b.cpu()
            if not torch.equal(a, b):
                diff = (a.float() - b.float()).abs()
                raise AssertionError(
                    f"{name}.{part}: card and CPU quantisation differ in "
                    f"{int((diff > 0).sum())} of {a.numel()} elements "
                    f"(max {float(diff.max()):.3e})")
        n_q += Q.is_qtensor(w)
    log(f"[parity-int8] {n_q} int8 leaves (payloads and scales) bit-equal on "
        f"card and CPU; quantised in {time.perf_counter() - t0:.1f} s")
    compare_card_cpu(arch, cpu_q, card_q, "parity-int8", kv_quant=True)
    del card_q
    torch.cuda.empty_cache()


def compare_card_cpu(arch, cpu_model, card_model, tag: str, *,
                     kv_quant: bool) -> None:
    """A batched bucketed prefill of 4 prompts and 4 greedy decode steps
    on the card and on the CPU, fed the same tokens (the CPU's greedy
    choices); last-position logits within PARITY_TOL of max |logit|."""
    import numpy as np
    import torch
    from repro_torch.serving.scheduler import prefill_rows, splice_rows

    rng = np.random.RandomState(1)
    lens = np.array([37, 64, 50, 21], np.int32)
    n, bucket, cache_len, steps = 4, 64, 128, 4
    toks = np.zeros((n, bucket), np.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = rng.randint(1, arch.vocab_size, size=s)

    def run(model, feed=None):
        d = model.device
        rows, logits = prefill_rows(model, torch.from_numpy(toks).to(d),
                                    torch.from_numpy(lens).to(d),
                                    kv_quant=kv_quant)
        grid = model.make_caches(n, cache_len, kv_quant=kv_quant)
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
    log(f"[{tag}] prefill + {steps} decode steps on both in "
        f"{time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max())
        rel = float((g - w).abs().max()) / scale
        worst = max(worst, rel)
        flips = (got_tok[j] != want_tok[j]).nonzero().flatten().tolist()
        line = f"[{tag}] position {j}: max rel err {rel:.3e}"
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
    log(f"[{tag}] ok: worst rel err {worst:.3e} (tolerance {PARITY_TOL})")


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

    # ---- phase 4 and 4b: the serving paths, each with the launch
    # counters set to 0 just before it and read just after
    counts = {"fp": serve_full_width(), "int8": serve_full_width(int8=True)}

    # ---- phase 5 and 5b: card vs CPU at full width, fp and INT8
    parity_full_width(dev)

    kernels = []
    for k in ops.KERNELS:
        name = k.__name__
        e = entries[name]
        src, replaces = SOURCES[name]
        path = "fp" if name in PATH_KERNELS["fp"] else "int8"
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[path][name],
               "launches_by_path": {p: c[name] for p, c in counts.items()},
               "max_abs_err": e["max_abs_err"], "ms": e["ms"],
               "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
               "bound_by": e["bound_by"], "library_ms": e["library_ms"],
               "shape": e["shape"]}
        for key in ("yardstick_ms", "yardstick", "library_error"):
            if key in e:
                row[key] = e[key]
        kernels.append(row)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
