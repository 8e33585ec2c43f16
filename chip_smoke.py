#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure propagates; the process exits non-zero):

1. card identity: ``nvidia-smi`` name and power limit, TF32 off;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
   print each kernel's ``ptxas -v`` registers, shared memory and spills,
   and fail if a head-dim-256 variant, ``rglru_scan`` or
   ``mlstm_chunkwise`` spills;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes plus one ragged case each, in fp32 (tolerance
   1e-3: summation order) and bf16 (5e-2, the tests/test_kernels.py bf16
   tolerance), each element's error against its own magnitude plus its
   row's RMS (case tables ``MM_CASES``, ``FA_CASES``, ``PA_CASES``); kernel,
   plain-version and one-PyTorch-call (yardstick only) times with CUDA
   events. The INT8 kernels (``quant_matmul``, the int8 body of
   ``paged_attention``) are checked the same way, with q/x in fp32
   (the INT8 path's activations) and bf16. ``quant_matmul``'s library
   call is ``torch._weight_int8pack_mm`` on the weight transposed ahead
   of time (or the error it raises); no PyTorch call computes the int8
   attention body. Their labelled yardsticks are ``torch.matmul`` on a
   weight dequantised ahead of time and SDPA over pre-dequantised K/V.
   Then the kernels at recurrentgemma-2b's shapes: ``rglru_scan`` (fp32
   [8, 2048, 2560] and a ragged [3, 37, 2560], bf16 too, bit-equal to its
   plain version; no PyTorch call computes a linear recurrence, so its
   library time is null), ``flash_attention`` at head dim 256 (bf16
   q,k,v [80, 2560, 256], causal, window 2048, and fp32 at [10, 2560,
   256] with the same window; SDPA with the window mask as its library
   call), ``paged_attention`` at head dim 256 (q [8, 10,
   256] over a ring grid [8, 2048, 1, 256], lengths 1-2048; masked SDPA)
   and ``xfer_matmul`` at R = 8 and 2048 for 2560x5120, 2560x7680,
   7680x2560 and the tied 2560x256000 unembedding, and at xlstm-350m's
   projections (1024x4096, 2048x2048, 2048x4, 2048x1024, 1024x1024; the
   tied 1024x50304 unembedding at R = 8). Then
   ``mlstm_chunkwise`` (table ``MLSTM_CASES``): xlstm-350m's prefill
   shape q, k, v [32, 2048, 512] in bf16 (timed), one row's heads [4,
   2048, 512] in fp32, head dims 32 and 64, identity-gate tails (the
   outputs before the tail and the final state also equal a run on the
   unpadded prefix) and nonzero initial states; h and the final (C, n,
   m) against the plain version; no PyTorch call computes the mLSTM, so
   its library time is null;
4. full-width qwen1.5-0.5b served greedily in bf16 through
   ``ServingEngine.run_until_drained()``: the fp kernels' launch
   counters must rise by their per-step counts, the INT8 ones stay 0;
4b. the same traffic under ``ServeConfig(quant=INT8_SERVE)``:
   ``quant_matmul`` rises by 169 x (decode steps + prefill groups), the
   int8 ``paged_attention`` by 24 x steps, ``flash_attention`` by 24 x
   groups, ``xfer_matmul`` and the fp ``paged_attention`` by 0;
4c. full-width, full-depth recurrentgemma-2b (18 RG-LRU + 8 local
   attention blocks) in bf16 on 8 slots of 2560 tokens (a ring of 2048):
   16 requests of 16-2400 prompt tokens (rids 0 and 1 wrap the ring at
   the fill, rid 2 during decode), 32 new tokens each; launches exactly
   ``xfer_matmul`` 147 x (decode steps + prefill groups), the fp
   ``paged_attention`` 8 x steps, ``flash_attention`` 8 x groups,
   ``rglru_scan`` 18 x groups, the INT8 kernels 0;
4d. full-width, full-depth xlstm-350m (12 x (mlstm, slstm)) in bf16 on 8
   slots of 2048 tokens: 16 requests of 16-2000 prompt tokens (rid 0 of
   2000 fills the 2048 bucket), 32 new tokens each; launches exactly
   ``mlstm_chunkwise`` 12 x prefill groups, ``xfer_matmul`` 109 x
   (decode steps + groups), every other kernel 0; 353,797,216
   parameters, 405,014,016 state bytes;
5. full-width parity: seeded fp32 weights, one batched prefill of 4
   prompts plus 4 greedy decode steps on the card vs on the CPU (plain
   versions): last-position logits within 2e-3 of max |logit|, greedy
   tokens equal (a flip is allowed only under a top-2 margin of 2e-3);
5b. the same under INT8: the same fp32 weights quantised on the card
   and on the CPU give bit-equal int8 payloads and scales; then the same
   prefill and decode steps over int8 grids, held to the same
   tolerance (a K/V value one int8 level apart on the two sides is
   inside it);
5c. recurrentgemma-2b at full width, depth cut to 4 layers (its
   ``reduced()`` count: one (rglru, rglru, attn) repeat and one suffix
   rglru), seeded fp32 weights: one prompt of 2100 tokens padded to 2560,
   then 5 decode steps past the ring's wrap, card vs CPU: logits and
   every layer's h within 2e-3 relative, greedy tokens equal;
5d. xlstm-350m at full width, depth cut to 4 layers (2 x (mlstm,
   slstm)), seeded fp32 weights: one prompt of 1500 tokens padded to
   2048, then 5 decode steps, card vs CPU: logits, every mLSTM state
   leaf and the sLSTM's h, m and c/n within 2e-3 relative, the sLSTM's
   c and n within 2e-2 (``SLSTM_SUM_TOL``), greedy tokens equal;
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
# and of full-width recurrentgemma-2b (phases 3, 4c, 5c): 8 slots of 2560
# tokens, a ring of 2048 (the window), 10 MQA heads of 256, width 2560
H_SLOTS, H_MAX_LEN, H_WINDOW, H_HEADS, H_WIDTH = 8, 2560, 2048, 10, 2560
# phase 4c prompt lengths: seeded uniform in H_PROMPT_RANGE, except the
# first three (rids 0 and 1 wrap the ring at the fill, rid 2 in decode);
# phase 5c prefills one prompt of H_PARITY_PROMPT tokens
H_PROMPT_RANGE, H_PROMPTS_FIXED, H_PARITY_PROMPT = (16, 2400), (2400, 2300, 2040), 2100
# and of full-width xlstm-350m (phases 3, 4d, 5d): 8 slots of 2048 tokens,
# 4 heads of 512 in the mLSTM (inner width 2048); phase 4d prompts are
# seeded uniform in X_PROMPT_RANGE except rid 0 (the 2048 bucket); phase
# 5d prefills one prompt of X_PARITY_PROMPT tokens
X_SLOTS, X_MAX_LEN, X_HEADS, X_HD = 8, 2048, 4, 512
X_PROMPT_RANGE, X_PROMPT_FIXED, X_PARITY_PROMPT = (16, 2000), 2000, 1500
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
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan.py:19"),
    "mlstm_chunkwise": ("src/repro_torch/kernels/csrc/mlstm_chunkwise.cu",
                        "src/repro/kernels/mlstm_kernel.py:20"),
}
# the kernels each serving path runs (phase 4: fp, phase 4b: INT8,
# phase 4c: the hybrid, phase 4d: the ssm family); a kernel's main path
# is the first that runs it
PATH_KERNELS = {"fp": ("xfer_matmul", "flash_attention", "paged_attention"),
                "int8": ("quant_matmul", "flash_attention",
                         "paged_attention_q8"),
                "hybrid": ("xfer_matmul", "flash_attention", "paged_attention",
                           "rglru_scan"),
                "ssm": ("xfer_matmul", "mlstm_chunkwise")}


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
    """Each element within ``tol`` of its own magnitude plus the RMS of
    its row (last axis) of ``want``: the error is held to the output's
    scale, so a zeroed or unmasked row of small values fails, and a
    row of large values is not held below fp32's resolution."""
    import torch
    torch.cuda.synchronize()
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    tol = TOL[dtype]
    bad = err > tol * (want.abs() + rms)
    max_err = float(err.max())
    if bool(bad.any()):
        worst = float((err / (want.abs() + rms)).max())
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {max_err:.3e}, {int(bad.sum())} "
                             f"elements off, worst err / (|want| + row RMS) "
                             f"{worst:.3e}, tol {tol})")
    return max_err


def iters_for(flops: float):
    """(timed iterations, warm-up calls): fewer for a case of 1e11 flops
    and more."""
    return (20, 3) if flops < 1e11 else (3, 1)


def record(entries: dict, name: str, entry, row: dict) -> None:
    """Keep a timed case as the kernel's entry: ``main`` for the first
    serving path that runs the kernel, ``hybrid`` or ``ssm`` as a
    sub-entry of that name."""
    if entry == "main":
        entries.setdefault(name, {}).update(row)
    elif entry in ("hybrid", "ssm"):
        entries.setdefault(name, {})[entry] = row


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

BOTH, FP32, BF16 = ("float32", "bfloat16"), ("float32",), ("bfloat16",)
# qwen1.5-0.5b (phases 4, 4b) and recurrentgemma-2b (phase 4c) widths
Q_D, Q_FF, Q_VOCAB, Q_HEADS = 1024, 2816, 151936, 16
H_FF, H_VOCAB = 7680, 256000
X_D, X_VOCAB = 1024, 50304  # xlstm-350m (phase 4d)

# xfer_matmul: (label, R, N, M, w given as a transposed view, dtypes,
# timed in bf16, entry); every projection at decode (R = slots) and
# prefill rows, the tied unembedding (embed.T), two ragged cases
MM_CASES = (
    [(f"R={r} {n}x{m}", r, n, m, False, BOTH, True, None)
     for r in (SLOTS, N_PREFILL * BUCKET)
     for n, m in ((Q_D, Q_D), (Q_D, Q_FF), (Q_FF, Q_D))]
    + [(f"R={SLOTS} {Q_D}x{Q_VOCAB} (embed.T)", SLOTS, Q_D, Q_VOCAB, True,
        BOTH, True, "main"),
       ("ragged R=13 1000x1001", 13, 1000, 1001, False, BOTH, False, None),
       ("ragged R=77 1000x1001 (w.T)", 77, 1000, 1001, True, BOTH, False,
        None)]
    # recurrentgemma-2b: w_in; w_out / wq / wo; wk / wv; w_gate / w_up;
    # w_down; the tied unembedding
    + [(f"R={r} {n}x{m}" + (" (embed.T)" if tr else ""), r, n, m, tr, BF16,
        True, "hybrid" if r == H_SLOTS and tr else None)
       for r in (H_SLOTS, 2048)
       for n, m, tr in ((H_WIDTH, 2 * H_WIDTH, False), (H_WIDTH, H_WIDTH, False),
                        (H_WIDTH, 256, False), (H_WIDTH, H_FF, False),
                        (H_FF, H_WIDTH, False), (H_WIDTH, H_VOCAB, True))]
    # xlstm-350m: w_up and the sLSTM's w; wq / wk / wv; w_i / w_f;
    # w_down; w_out; at decode also the tied unembedding
    + [(f"R={r} {n}x{m}" + (" (embed.T)" if tr else ""), r, n, m, tr, BF16,
        True, "ssm" if tr else None)
       for r in (X_SLOTS, 2048)
       for n, m, tr in ((X_D, 4 * X_D, False), (2 * X_D, 2 * X_D, False),
                        (2 * X_D, X_HEADS, False), (2 * X_D, X_D, False),
                        (X_D, X_D, False), (X_D, X_VOCAB, True))
       if r == X_SLOTS or not tr])

# flash_attention: (label, BH, S, D, window, causal, dtypes, timed in
# bf16, entry); the prefill self-attention of each path, then small and
# ragged cases. The fp32 plain version at the hybrid's BH = 80 takes 8
# GB, so its fp32 check runs at BH = 10 (one row's heads), full S and
# window.
FA_CASES = [
    (f"BH={N_PREFILL * Q_HEADS} S={BUCKET}", N_PREFILL * Q_HEADS, BUCKET, 64,
     0, True, BOTH, True, "main"),
    ("BH=32 S=64", 32, 64, 64, 0, True, BOTH, True, None),
    ("BH=16 S=16", 16, 16, 64, 0, True, BOTH, True, None),
    ("ragged BH=6 S=100", 6, 100, 64, 0, True, BOTH, False, None),
    ("window BH=6 S=200 w=48", 6, 200, 64, 48, True, BOTH, False, None),
    ("non-causal BH=4 S=96", 4, 96, 64, 0, False, BOTH, False, None),
    (f"BH={H_SLOTS * H_HEADS} S={H_MAX_LEN} D=256 window {H_WINDOW}",
     H_SLOTS * H_HEADS, H_MAX_LEN, 256, H_WINDOW, True, BF16, True, "hybrid"),
    (f"BH={H_HEADS} S={H_MAX_LEN} D=256 window {H_WINDOW}", H_HEADS,
     H_MAX_LEN, 256, H_WINDOW, True, FP32, False, None),
    ("ragged BH=6 S=300 D=256 window 100", 6, 300, 256, 100, True, BOTH,
     False, None),
    ("BH=4 S=77 D=256", 4, 77, 256, 0, True, BOTH, False, None),
    ("non-causal BH=3 S=50 D=256", 3, 50, 256, 0, False, BOTH, False, None)]

# paged_attention: (label, B, H, G, D, (pages, page size), table columns
# (None: the dense grid read through an identity table), lengths,
# timed in bf16, entry); every case in fp32 and bf16
PA_CASES = [
    (f"grid q[{SLOTS},{Q_HEADS},64] pool[{SLOTS},{MAX_LEN},{Q_HEADS},64]",
     SLOTS, Q_HEADS, Q_HEADS, 64, (SLOTS, MAX_LEN), None,
     [1, 17, 64, 128, 129, 200, 233, MAX_LEN], True, "main"),
    ("ragged GQA H=8 G=2 ps=16", 3, 8, 2, 64, (3 * 9 + 2, 16), 9,
     [1, 77, 9 * 16], False, None),
    (f"ring q[{H_SLOTS},{H_HEADS},256] pool[{H_SLOTS},{H_WINDOW},1,256]",
     H_SLOTS, H_HEADS, 1, 256, (H_SLOTS, H_WINDOW), None,
     [1, 17, 255, 256, 257, 1000, H_WINDOW - 1, H_WINDOW], True, "hybrid"),
    ("ragged D=256 H=4 G=2 ps=16", 3, 4, 2, 256, (3 * 5 + 2, 16), 5,
     [1, 40, 5 * 16], False, None)]


def check_kernels(dev) -> dict:
    """Checks every case of the tables above, ``quant_matmul``, the int8
    ``paged_attention`` body and ``rglru_scan``; prints every case and
    returns the timed entry per kernel (and its ``hybrid`` sub-entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries = {}

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    def times(fn, plain, lib, flops):
        it, wu = iters_for(flops)
        return (time_ms(fn, it, wu), time_ms(plain, it, wu),
                time_ms(lib, it, wu))

    for label, r, n, m, transposed, dnames, timed, entry in MM_CASES:
        for dname in dnames:
            dt = dtypes[dname]
            x = randn(r, n, dt=dt)
            if transposed:
                w = randn(m, n, dt=dt, scale=n ** -0.5).T  # strided view
            else:
                w = randn(n, m, dt=dt, scale=n ** -0.5)
            got = ops.matmul(x, w)
            err = compare(f"xfer_matmul {label} {dname}", got,
                          ops.matmul_ref(x, w), dname)
            line = f"[kernel] xfer_matmul {label} {dname}: max_abs_err {err:.3e}"
            if timed and dname == "bfloat16":
                flops = 2.0 * r * n * m
                ms, plain, lib = times(lambda: ops.matmul(x, w),
                                       lambda: ops.matmul_ref(x, w),
                                       lambda: torch.matmul(x, w), flops)
                b, kind = bound_ms((r * n + n * m + r * m) * x.element_size(),
                                   flops, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f} bound_ms {b:.4f} ({kind})")
                record(entries, "xfer_matmul", entry, dict(
                    shape=f"x[{r},{n}] @ embed.T[{n},{m}] bf16",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=kind, library_ms=lib))
            log(line)
            del x, w, got

    for label, bh, s, d, window, causal, dnames, timed, entry in FA_CASES:
        for dname in dnames:
            q, k, v = (randn(bh, s, d, dt=dtypes[dname]) for _ in range(3))
            got = ops.attention(q, k, v, causal=causal, window=window)
            want = ops.attention_ref(q, k, v, causal=causal, window=window)
            err = compare(f"flash_attention {label} {dname}", got, want, dname)
            del want
            line = f"[kernel] flash_attention {label} {dname}: max_abs_err {err:.3e}"
            if timed and dname == "bfloat16":
                # causal (+ window): the visible query-key pairs only
                pairs = bh * sum(min(i + 1, window or s) for i in range(s))
                pos = torch.arange(s, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & \
                    (pos[:, None] - pos[None, :] < (window or s))
                q4, k4, v4 = (t[None] for t in (q, k, v))
                ms, plain, lib = times(
                    lambda: ops.attention(q, k, v, window=window),
                    lambda: ops.attention_ref(q, k, v, window=window),
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask if window else None,
                        is_causal=not window), 4.0 * d * pairs)
                b, kind = bound_ms(4 * bh * s * d * q.element_size(),
                                   4.0 * d * pairs, dname)
                lib_note = " (SDPA, window mask)" if window else ""
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f}{lib_note} bound_ms {b:.4f} ({kind})")
                win = f" window {window}" if window else ""
                record(entries, "flash_attention", entry, dict(
                    shape=f"q,k,v[{bh},{s},{d}] causal{win} bf16",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                    bound_by=kind, library_ms=lib))
            log(line)
            del q, k, v, got

    for (label, b, h, g, d, (n_pages, ps), m, lengths, timed,
         entry) in PA_CASES:
        for dname, dt in dtypes.items():
            q = randn(b, h, d, dt=dt)
            kp = randn(n_pages, ps, g, d, dt=dt)
            vp = randn(n_pages, ps, g, d, dt=dt)
            if m is None:  # the dense grid: one page per row
                tb = torch.arange(b, device=dev, dtype=torch.int32)[:, None]
            else:
                perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
                tb = perm[:b * m].reshape(b, m).to(torch.int32)
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            got = ops.paged_attn(q, kp, vp, tb, lens)
            want = ops.paged_attn_ref(q, kp, vp, tb, lens)
            err = compare(f"paged_attention {label} {dname}", got, want, dname)
            line = f"[kernel] paged_attention {label} {dname}: max_abs_err {err:.3e}"
            if not (timed and dname == "bfloat16"):
                log(line)
                continue
            esz, t = q.element_size(), tb.shape[1] * ps

            def bound(tokens):
                return bound_ms(2 * q.numel() * esz + 2 * tokens * g * d * esz
                                + tb.numel() * 4 + lens.numel() * 4,
                                4.0 * h * d * tokens, dname)

            # yardstick: SDPA over the same grid with a length mask
            q4 = q[:, :, None, :]                       # [B, H, 1, D]
            k4 = kp.permute(0, 2, 1, 3)                 # [B, G, T, D]
            v4 = vp.permute(0, 2, 1, 3)
            mask = (torch.arange(t, device=dev)[None] < lens[:, None])
            mask = mask[:, None, None, :]
            ms, plain, lib = times(
                lambda: ops.paged_attn(q, kp, vp, tb, lens),
                lambda: ops.paged_attn_ref(q, kp, vp, tb, lens),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=h != g), 0)
            nb, kind = bound(sum(lengths))
            lib_note = " (SDPA, length mask)" if h == g else \
                " (SDPA, length mask, GQA)"
            log(line + f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f}{lib_note} bound_ms {nb:.4f} ({kind})")
            record(entries, "paged_attention", entry, dict(
                shape=f"q[{b},{h},{d}] grid[{b},{t},{g},{d}] lengths "
                      f"{lengths} bf16",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=nb,
                bound_by=kind, library_ms=lib))
            # every row at the full grid, as most decode steps run it
            full = torch.full_like(lens, t)
            ms = time_ms(lambda: ops.paged_attn(q, kp, vp, tb, full))
            nb, kind = bound(b * t)
            log(f"[kernel] paged_attention {label}, every length {t}, "
                f"{dname}: ms {ms:.4f} bound_ms {nb:.4f} ({kind})")
            del q, kp, vp, got, want
    entries.update(check_int8_kernels(dev, gen))
    entries.update(check_rglru(dev, gen))
    entries.update(check_mlstm(dev, gen))
    torch.cuda.empty_cache()
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


def check_rglru(dev, gen) -> dict:
    """``rglru_scan`` at every RG-LRU prefill's shape, a, b [n, bucket,
    2560], and a ragged one: bit-equal to its plain version; timed in
    fp32, the path's carry dtype."""
    import torch
    from repro_torch.kernels import ops

    entries = {}
    for label, (b, s, w) in ((f"[{H_SLOTS},{H_WINDOW},{H_WIDTH}]",
                              (H_SLOTS, H_WINDOW, H_WIDTH)),
                             ("ragged [3,37,2560]", (3, 37, H_WIDTH))):
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            a = torch.rand(b, s, w, generator=gen, device=dev).to(dt)
            bx = torch.randn(b, s, w, generator=gen, device=dev).to(dt)
            h0 = torch.randn(b, w, generator=gen, device=dev)
            got = ops.lru_scan(a, bx, h0)
            want = ops.lru_scan_ref(a, bx, h0)
            err = compare(f"rglru_scan {label} {dname}", got, want, dname)
            if not torch.equal(got, want):
                raise AssertionError(f"rglru_scan {label} {dname}: not bit-equal "
                                     f"to its plain version")
            line = (f"[kernel] rglru_scan {label} {dname}: max_abs_err {err:.3e} "
                    f"(bit-equal)")
            if dname == "float32" and not label.startswith("ragged"):
                ms = time_ms(lambda: ops.lru_scan(a, bx, h0))
                plain = time_ms(lambda: ops.lru_scan_ref(a, bx, h0), iters=3,
                                warmup=1)
                nb, kind = bound_ms(3 * b * s * w * 4 + b * w * 4,
                                    2.0 * b * s * w, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms null "
                         f"(no PyTorch call computes a linear recurrence) "
                         f"bound_ms {nb:.4f} ({kind})")
                entries["rglru_scan"] = dict(
                    shape=f"a,b[{b},{s},{w}] f32, h0[{b},{w}]", max_abs_err=err,
                    ms=ms, plain_ms=plain, bound_ms=nb, bound_by=kind,
                    library_ms=None)
            log(line)
            del a, bx, got, want
    return entries


# mlstm_chunkwise: (label, BH, S, D, dtypes, identity-gate tail steps,
# nonzero initial state, timed in bf16); S need not divide by the
# kernel's 16-step chunk
MLSTM_CASES = [
    (f"[{X_SLOTS * X_HEADS},{X_MAX_LEN},{X_HD}]", X_SLOTS * X_HEADS, X_MAX_LEN,
     X_HD, BF16, 0, False, True),
    (f"[{X_HEADS},{X_MAX_LEN},{X_HD}]", X_HEADS, X_MAX_LEN, X_HD, FP32, 0,
     False, False),
    ("reduced D=32 [8,100,32]", 8, 100, 32, BOTH, 0, False, False),
    ("D=64 [6,77,64]", 6, 77, 64, BOTH, 0, False, False),
    ("tail [4,300,512], last 87 identity", 4, 300, X_HD, BOTH, 87, False,
     False),
    ("state [8,200,512]", 8, 200, X_HD, BOTH, 0, True, False),
    ("state + tail D=32 [5,45,32], last 13 identity", 5, 45, 32, BOTH, 13,
     True, False)]
MLSTM_CHUNK = 16  # the kernel's chunk, for its operation count


def mlstm_bound(bh: int, s: int, d: int, esz: int, dname: str,
                with_state: bool):
    """Bytes: q, k, v read and h written once, the f32 gates read, the
    final state written (and the initial one read when it is given, not
    zeros); operations: per step q C and the rank-16 fold (2 D^2 flops
    each), q n and the fold of n, and per chunk the causal pairs' q.k and
    scores.v."""
    state = bh * (d * d + d + 1) * 4
    nbytes = (4 * bh * s * d * esz + 2 * bh * s * 4
              + (2 if with_state else 1) * state)
    pairs = sum(min(MLSTM_CHUNK, s - t) * (min(MLSTM_CHUNK, s - t) + 1) // 2
                for t in range(0, s, MLSTM_CHUNK))
    flops = bh * (4.0 * s * d * d + 4.0 * s * d + 4.0 * pairs * d)
    return bound_ms(nbytes, flops, dname), flops


def check_mlstm(dev, gen) -> dict:
    """``mlstm_chunkwise`` (its state entry ``mlstm_fold``) on every case
    of MLSTM_CASES: h and the final (C, n, m) against the plain version;
    with an identity-gate tail, the outputs before it and the final
    state against the kernel on the unpadded prefix too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for label, bh, s, d, dnames, tail, with_state, timed in MLSTM_CASES:
        for dname in dnames:
            dt = dtypes[dname]
            q, k, v = randn(bh, s, d).to(dt), randn(bh, s, d, scale=d ** -0.5).to(dt), \
                randn(bh, s, d).to(dt)
            it = randn(bh, s)
            logf = F.logsigmoid(randn(bh, s) + 3.0)  # b_f = 3
            state = ()
            if with_state:
                state = (randn(bh, d, d, scale=0.3), randn(bh, d, scale=0.3),
                         randn(bh))
            keep = s - tail
            if tail:
                it[:, keep:], logf[:, keep:] = -1e30, 0.0
            args = (q, k, v, it, logf, *state)
            got = ops.mlstm_fold(*args)
            want = ops.mlstm_fold_ref(*args)
            errs = [compare(f"mlstm_chunkwise {label} {dname} {part}", g, w, dname)
                    for part, g, w in zip(("h", "C", "n", "m"), got, want)]
            line = (f"[kernel] mlstm_chunkwise {label} {dname}: max_abs_err h "
                    f"{errs[0]:.3e} C {errs[1]:.3e} n {errs[2]:.3e} m {errs[3]:.3e}")
            if tail:
                pre = ops.mlstm_fold(q[:, :keep], k[:, :keep], v[:, :keep],
                                     it[:, :keep], logf[:, :keep], *state)
                perr = [compare(f"mlstm_chunkwise {label} {dname} {part} vs prefix",
                                g, w, dname)
                        for part, g, w in zip(("h", "C", "n", "m"),
                                              (got[0][:, :keep], *got[1:]), pre)]
                line += f"; vs the {keep}-step prefix max {max(perr):.3e}"
            del want
            if timed and dname == "bfloat16":
                ms = time_ms(lambda: ops.mlstm_fold(*args))
                plain = time_ms(lambda: ops.mlstm_fold_ref(*args), 3, 1)
                (nb, kind), flops = mlstm_bound(bh, s, d, q.element_size(), dname,
                                                with_state)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms null (no "
                         f"PyTorch call computes the mLSTM) bound_ms {nb:.4f} "
                         f"({kind}; {flops:.4e} flops)")
                entries["mlstm_chunkwise"] = dict(
                    shape=f"q,k,v[{bh},{s},{d}] bf16, gates f32, zero state",
                    max_abs_err=errs[0], ms=ms, plain_ms=plain, bound_ms=nb,
                    bound_by=kind, library_ms=None)
            log(line)
            del q, k, v, got
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


# recurrentgemma-2b at full width and depth, as the reference's
# jax.eval_shape of lm.init_params counts it, and its ring KV grid
HYBRID_PARAMS = 2_682_237_440
HYBRID_KV_BYTES = 134_217_728  # 8 attention layers x k, v x 8 x 2048 x 256 bf16


def serve_hybrid() -> dict:
    """Phase 4c: 16 requests through full-width, full-depth
    recurrentgemma-2b in bf16 on 8 slots of 2560 tokens (a ring of 2048,
    buckets 2048 and 2560). Rids 0 and 1 (2400, 2300 tokens) wrap the
    ring at the fill, rid 2 (2040) during decode. Returns the kernels'
    launch counts over the run, after checking them exactly."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    tag = "serve-hybrid"
    arch = get_arch("recurrentgemma-2b")
    n_req, new_tokens = 16, 32
    config = ServeConfig(slots=H_SLOTS, max_len=H_MAX_LEN, seed=0, lookahead=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(arch, config.seed)  # on the card, bf16
    engine = ServingEngine(arch, model, config=config)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{tag}] {arch.name}: {arch.num_layers} layers {model.kinds.count('rglru')} "
        f"rglru + {model.kinds.count('attn')} attn, d {arch.d_model}, "
        f"{model.dtype}, params + grid ready in {time.perf_counter() - t0:.1f} s")
    if n_params != HYBRID_PARAMS:
        raise AssertionError(f"{n_params} parameters, the reference has "
                             f"{HYBRID_PARAMS}")
    rng = np.random.RandomState(0)
    lo, hi = H_PROMPT_RANGE
    lens = [int(x) for x in rng.randint(lo, hi + 1, size=n_req)]
    lens[:len(H_PROMPTS_FIXED)] = H_PROMPTS_FIXED
    for rid, s in enumerate(lens):
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
    n_rglru, n_attn = model.kinds.count("rglru"), model.kinds.count("attn")
    per_pass = 5 * n_rglru + 7 * n_attn + 1  # projections + the unembedding
    want = {"xfer_matmul": per_pass * (steps + groups),
            "paged_attention": n_attn * steps,
            "flash_attention": n_attn * groups,
            "rglru_scan": n_rglru * groups,
            "quant_matmul": 0, "paged_attention_q8": 0}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"expected {n} ({steps} decode steps, "
                                 f"{groups} prefill groups)")
    log(f"[{tag}] step_stats {json.dumps(engine.step_stats())}")
    log(f"[{tag}] prefill_stats {json.dumps(pstats)}")
    kv = sum(c[k].numel() * c[k].element_size() for c in engine.caches
             for k in ("k", "v") if k in c)
    state = {name: sum(c[name].numel() * c[name].element_size()
                       for c in engine.caches if name in c)
             for name in ("h", "conv")}
    if kv != HYBRID_KV_BYTES:
        raise AssertionError(f"KV grid of {kv} bytes, expected {HYBRID_KV_BYTES}")
    log(f"[{tag}] params {n_params} weight_bytes {weight_bytes} kv_bytes {kv} "
        f"state_bytes {state} peak_allocated_bytes "
        f"{torch.cuda.max_memory_allocated()}")
    log(f"[{tag}] rid=0 out={done[0].out_tokens[:8]}")
    del engine, model
    torch.cuda.empty_cache()
    return counts


# xlstm-350m at full width and depth, as the reference's jax.eval_shape of
# lm.init_params counts it, and its decode state on X_SLOTS slots: 12
# mLSTM (C [8,4,512,512], n, m) and 12 sLSTM (c, n, h, m [8,1024]), f32
XLSTM_PARAMS = 353_797_216
XLSTM_STATE_BYTES = 405_014_016


def serve_xlstm() -> dict:
    """Phase 4d: 16 requests through full-width, full-depth xlstm-350m in
    bf16 on 8 slots of 2048 tokens. Returns the kernels' launch counts
    over the run, after checking them exactly."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    tag = "serve-ssm"
    arch = get_arch("xlstm-350m")
    n_req, new_tokens = 16, 32
    config = ServeConfig(slots=X_SLOTS, max_len=X_MAX_LEN, seed=0, lookahead=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(arch, config.seed)  # on the card, bf16
    engine = ServingEngine(arch, model, config=config)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{tag}] {arch.name}: {arch.num_layers} layers {model.kinds.count('mlstm')} "
        f"mlstm + {model.kinds.count('slstm')} slstm, d {arch.d_model}, "
        f"{model.dtype}, params + states ready in {time.perf_counter() - t0:.1f} s")
    if n_params != XLSTM_PARAMS:
        raise AssertionError(f"{n_params} parameters, the reference has "
                             f"{XLSTM_PARAMS}")
    rng = np.random.RandomState(0)
    lo, hi = X_PROMPT_RANGE
    lens = [int(x) for x in rng.randint(lo, hi + 1, size=n_req)]
    lens[0] = X_PROMPT_FIXED
    for rid, s in enumerate(lens):
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
    n_ml, n_sl = model.kinds.count("mlstm"), model.kinds.count("slstm")
    per_pass = 7 * n_ml + 2 * n_sl + 1  # projections + the unembedding
    want = {name: 0 for name in counts}
    want.update(xfer_matmul=per_pass * (steps + groups),
                mlstm_chunkwise=n_ml * groups)
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"expected {n} ({steps} decode steps, "
                                 f"{groups} prefill groups)")
    log(f"[{tag}] step_stats {json.dumps(engine.step_stats())}")
    log(f"[{tag}] prefill_stats {json.dumps(pstats)}")
    state = {}
    for c in engine.caches:
        for name, leaf in c.items():
            state[name] = state.get(name, 0) + leaf.numel() * leaf.element_size()
    if sum(state.values()) != XLSTM_STATE_BYTES:
        raise AssertionError(f"decode state of {sum(state.values())} bytes, "
                             f"expected {XLSTM_STATE_BYTES}")
    log(f"[{tag}] params {n_params} weight_bytes {weight_bytes} state_bytes "
        f"{sum(state.values())} {state} peak_allocated_bytes "
        f"{torch.cuda.max_memory_allocated()}")
    log(f"[{tag}] rid=0 out={done[0].out_tokens[:8]}")
    del engine, model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 5: full-width parity, card vs CPU
# --------------------------------------------------------------------------

PARITY_TOL = 2e-3  # max |logits_card - logits_cpu| / max |logits_cpu|
# The sLSTM's c and n each sum ~1500 steps of weights exp(i - m) whose
# exponent is rounded at fp32's resolution of its stabiliser m (which
# grows to hundreds: its ulp is ~3e-5 at 256-512), so each carries
# ~1e-3 noise on any platform; the noise is common to both, and c / n
# (which h = sigmoid(o) c / n reads), h and m are held to PARITY_TOL.
SLSTM_SUM_TOL = 2e-2


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


def parity_hybrid(dev) -> None:
    """Phase 5c: recurrentgemma-2b at full width with the depth cut to its
    ``reduced()`` layer count (4: one (rglru, rglru, attn) repeat and one
    suffix rglru), seeded fp32 weights on the card and on the CPU. One
    prompt of 2100 tokens, right-padded to the 2560 bucket, is prefilled
    (the window mask and the ring-exact fill both act), then 5 decode
    steps run past the wrap, fed the CPU's greedy tokens. Last-position
    logits and every layer's h within PARITY_TOL relative, greedy tokens
    equal."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.scheduler import prefill_rows, splice_rows

    tag = "parity-hybrid"
    full = get_arch("recurrentgemma-2b")
    arch = dataclasses.replace(full, num_layers=full.reduced().num_layers)
    t0 = time.perf_counter()
    cpu_model = init_params(arch, 1, device="cpu")  # fp32
    card_model = copy.deepcopy(cpu_model).to(dev)
    log(f"[{tag}] {arch.num_layers} layers {cpu_model.kinds}, d {arch.d_model}: "
        f"fp32 weights on CPU and card in {time.perf_counter() - t0:.1f} s")
    prompt_len, bucket, steps = H_PARITY_PROMPT, H_MAX_LEN, 5
    rng = np.random.RandomState(2)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :prompt_len] = rng.randint(1, arch.vocab_size, size=prompt_len)
    lens = np.array([prompt_len], np.int32)
    rec = [i for i, k in enumerate(cpu_model.kinds) if k == "rglru"]

    def run(model, feed=None):
        d = model.device
        rows, logits = prefill_rows(model, torch.from_numpy(toks).to(d),
                                    torch.from_numpy(lens).to(d))
        grid = model.make_caches(1, H_MAX_LEN)
        splice_rows(grid, rows, torch.arange(1, device=d))
        out = [logits[:, -1].float().cpu()]
        hs = [[grid[i]["h"].float().cpu() for i in rec]]
        chosen = [out[-1].argmax(-1).to(torch.int32)]
        pos = torch.from_numpy(lens).to(d)[:, None]
        for j in range(steps):
            tok = (feed[j] if feed is not None else chosen[-1]).to(d)[:, None]
            hidden, grid = model(tok, caches=grid, positions=pos)
            out.append(model.logits(hidden)[:, -1].float().cpu())
            hs.append([grid[i]["h"].float().cpu() for i in rec])
            chosen.append(out[-1].argmax(-1).to(torch.int32))
            pos = pos + 1
        ring = grid[cpu_model.kinds.index("attn")]["pos"].cpu()
        return out, hs, chosen, ring

    t0 = time.perf_counter()
    with torch.no_grad():
        want, want_h, want_tok, want_ring = run(cpu_model)
        got, got_h, got_tok, got_ring = run(card_model, feed=want_tok)
    log(f"[{tag}] prefill of {prompt_len} tokens (bucket {bucket}) + {steps} "
        f"decode steps on both in {time.perf_counter() - t0:.1f} s")
    if not torch.equal(want_ring, got_ring):
        raise AssertionError(f"[{tag}] ring positions differ")
    held = int((want_ring >= 0).sum())
    if held != H_WINDOW or int(want_ring.max()) != prompt_len + steps - 1:
        raise AssertionError(f"[{tag}] ring holds {held} positions up to "
                             f"{int(want_ring.max())}, expected the last "
                             f"{H_WINDOW} up to {prompt_len + steps - 1}")
    worst = 0.0
    for j in range(steps + 1):
        scale = float(want[j].abs().max())
        rel = float((got[j] - want[j]).abs().max()) / scale
        rel_h = max(float((g - w).abs().max()) / float(w.abs().max())
                    for g, w in zip(got_h[j], want_h[j]))
        worst = max(worst, rel, rel_h)
        log(f"[{tag}] position {j}: logits max rel err {rel:.3e}, h max rel "
            f"err {rel_h:.3e}, token card {got_tok[j].tolist()} cpu "
            f"{want_tok[j].tolist()}")
        if not torch.equal(got_tok[j], want_tok[j]):
            raise AssertionError(f"[{tag}] greedy token differs at position {j}")
    if worst > PARITY_TOL:
        raise AssertionError(f"[{tag}] card vs CPU: rel err {worst:.3e} > "
                             f"{PARITY_TOL}")
    log(f"[{tag}] ok: worst rel err {worst:.3e} (tolerance {PARITY_TOL}); ring "
        f"holds positions {int(want_ring.min())}..{int(want_ring.max())}")
    del card_model
    torch.cuda.empty_cache()


def parity_xlstm(dev) -> None:
    """Phase 5d: xlstm-350m at full width with the depth cut to 4 layers
    (2 x (mlstm, slstm)), seeded fp32 weights on the card and on the CPU.
    One prompt of 1500 tokens, right-padded to the 2048 bucket, is
    prefilled (identity gates on the mLSTM tail, mask-carry in the
    sLSTM), then 5 decode steps, fed the CPU's greedy tokens.
    Last-position logits, every mLSTM state leaf and the sLSTM's h, m
    and c / n within PARITY_TOL relative, the sLSTM's c and n within
    SLSTM_SUM_TOL, greedy tokens equal."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    from repro_torch.serving.scheduler import prefill_rows, splice_rows

    tag = "parity-ssm"
    arch = dataclasses.replace(get_arch("xlstm-350m"), num_layers=4)
    t0 = time.perf_counter()
    cpu_model = init_params(arch, 1, device="cpu")  # fp32
    card_model = copy.deepcopy(cpu_model).to(dev)
    log(f"[{tag}] {arch.num_layers} layers {cpu_model.kinds}, d {arch.d_model}: "
        f"fp32 weights on CPU and card in {time.perf_counter() - t0:.1f} s")
    prompt_len, bucket, steps = X_PARITY_PROMPT, X_MAX_LEN, 5
    rng = np.random.RandomState(3)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :prompt_len] = rng.randint(1, arch.vocab_size, size=prompt_len)
    lens = np.array([prompt_len], np.int32)

    def states(grid):
        out = {f"{i}.{k}": v.float().cpu() for i, c in enumerate(grid)
               for k, v in c.items()}
        for i, c in enumerate(grid):
            if "c" in c:  # sLSTM: the normalised cell that h reads
                out[f"{i}.c/n"] = (c["c"] / c["n"]).float().cpu()
        return out

    def tol(leaf):
        return SLSTM_SUM_TOL if leaf.split(".")[1] in ("c", "n") \
            and cpu_model.kinds[int(leaf.split(".")[0])] == "slstm" \
            else PARITY_TOL

    def run(model, feed=None):
        d = model.device
        rows, logits = prefill_rows(model, torch.from_numpy(toks).to(d),
                                    torch.from_numpy(lens).to(d))
        grid = model.make_caches(1, X_MAX_LEN)
        splice_rows(grid, rows, torch.arange(1, device=d))
        out = [logits[:, -1].float().cpu()]
        sts = [states(grid)]
        chosen = [out[-1].argmax(-1).to(torch.int32)]
        pos = torch.from_numpy(lens).to(d)[:, None]
        for j in range(steps):
            tok = (feed[j] if feed is not None else chosen[-1]).to(d)[:, None]
            hidden, grid = model(tok, caches=grid, positions=pos)
            out.append(model.logits(hidden)[:, -1].float().cpu())
            sts.append(states(grid))
            chosen.append(out[-1].argmax(-1).to(torch.int32))
            pos = pos + 1
        return out, sts, chosen

    t0 = time.perf_counter()
    with torch.no_grad():
        want, want_s, want_tok = run(cpu_model)
        got, got_s, got_tok = run(card_model, feed=want_tok)
    log(f"[{tag}] prefill of {prompt_len} tokens (bucket {bucket}) + {steps} "
        f"decode steps on both in {time.perf_counter() - t0:.1f} s")
    m_max = {k: float(w.abs().max()) for k, w in want_s[0].items()
             if k.endswith(".m")}
    log(f"[{tag}] max |m| per layer after the prefill (CPU): {m_max}")
    worst = {}
    for j in range(steps + 1):
        scale = float(want[j].abs().max())
        rel = float((got[j] - want[j]).abs().max()) / scale
        rel_s = {k: float((got_s[j][k] - w).abs().max()) / float(w.abs().max())
                 for k, w in want_s[j].items()}
        worst["logits"] = max(worst.get("logits", 0.0), rel)
        for k, r in rel_s.items():
            worst[k] = max(worst.get(k, 0.0), r)
        leaf = max(rel_s, key=rel_s.get)
        log(f"[{tag}] position {j}: logits max rel err {rel:.3e}, state max rel "
            f"err {rel_s[leaf]:.3e} ({leaf}), token card {got_tok[j].tolist()} "
            f"cpu {want_tok[j].tolist()}")
        if not torch.equal(got_tok[j], want_tok[j]):
            raise AssertionError(f"[{tag}] greedy token differs at position {j}")
    bad = {k: r for k, r in worst.items()
           if r > (PARITY_TOL if k == "logits" else tol(k))}
    if bad:
        raise AssertionError(f"[{tag}] card vs CPU over tolerance: {bad} "
                             f"(PARITY_TOL {PARITY_TOL}, sLSTM c and n "
                             f"{SLSTM_SUM_TOL})")
    log(f"[{tag}] ok: worst rel err {json.dumps(worst)} (tolerance {PARITY_TOL}; "
        f"sLSTM c and n {SLSTM_SUM_TOL})")
    del card_model
    torch.cuda.empty_cache()


# kernels that must compile without spills: the head-dim-256 variants
# (flash_split_kernel, the 256-thread paged_kernel), rglru_scan and
# mlstm_chunkwise
NO_SPILL = ("flash_split_kernel", "paged_kernel", "rglru_kernel",
            "mlstm_kernel")


def check_ptxas(build_log: dict) -> None:
    """Print each compiled kernel's ``ptxas -v`` lines (registers, shared
    memory, stack and spills) and fail if a kernel named in NO_SPILL
    spills."""
    import re
    for name, out in build_log.items():
        entry = None
        for line in out.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[ptxas] {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and entry and any(k in entry for k in NO_SPILL) \
                    and (int(m.group(1)) or int(m.group(2))):
                raise AssertionError(f"{entry} spills: {line.strip()}")


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
    check_ptxas(build.build_log)

    # ---- phase 3: kernels vs plain versions
    entries = check_kernels(dev)

    # ---- phase 4 and 4b: the serving paths, each with the launch
    # counters set to 0 just before it and read just after
    counts = {"fp": serve_full_width(), "int8": serve_full_width(int8=True)}
    # ---- phase 4c: the hybrid path (recurrentgemma-2b)
    counts["hybrid"] = serve_hybrid()
    # ---- phase 4d: the ssm path (xlstm-350m)
    counts["ssm"] = serve_xlstm()

    # ---- phase 5 and 5b: card vs CPU at full width, fp and INT8
    parity_full_width(dev)
    # ---- phase 5c: the same for the hybrid, depth cut to 4 layers
    parity_hybrid(dev)
    # ---- phase 5d: the same for the ssm family, depth cut to 4 layers
    parity_xlstm(dev)

    kernels = []
    for k in ops.KERNELS:
        name = k.__name__
        e = entries[name]
        src, replaces = SOURCES[name]
        path = next(p for p, ks in PATH_KERNELS.items() if name in ks)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[path][name],
               "launches_by_path": {p: c[name] for p, c in counts.items()},
               "max_abs_err": e["max_abs_err"], "ms": e["ms"],
               "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
               "bound_by": e["bound_by"], "library_ms": e["library_ms"],
               "shape": e["shape"]}
        for key in ("yardstick_ms", "yardstick", "library_error", "hybrid",
                    "ssm"):
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
