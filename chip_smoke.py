#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (each failure propagates; the process exits non-zero):

1. card identity: ``nvidia-smi`` name and power limit, TF32 off;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc,
   print each kernel's ``ptxas -v`` registers, shared memory and spills,
   and fail if a kernel named in ``NO_SPILL`` spills (every
   ``flash_attention`` instance, both ``rglru_scan`` routes, both
   ``mlstm_chunkwise``
   kernels, ``xfer_matmul``'s and ``quant_matmul``'s streaming and
   tensor-core kernels, both ``paged_attention`` bodies);
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes plus ragged cases (``xfer_matmul`` and
   ``quant_matmul`` also print the kernel their route picked; they, both
   ``paged_attention`` bodies, which reduce across blocks,
   ``flash_attention`` (its terms kernel merges two warpgroups),
   ``rglru_scan`` and ``mlstm_chunkwise`` must give bit-equal outputs on
   two calls; every
   timed matmul shape is kept in
   the kernel line under ``shapes``, the paged cases with their
   every-length times; each ``flash_attention`` line names its kernel
   instance with its ``ptxas`` registers and spills), in fp32 (tolerance
   1e-3: summation order) and bf16 (5e-2, the tests/test_kernels.py bf16
   tolerance; it also holds the tensor-core ``flash_attention``'s
   rounding of P to bf16, which the TPU body does not have), each
   element's error against its own magnitude plus its row's RMS (case
   tables ``MM_CASES``, ``FA_CASES``, ``FA_KV_CASES``, ``PA_CASES``,
   ``QM_CASES``); kernel, plain-version and one-PyTorch-call (yardstick
   only) times with CUDA events. ``flash_attention`` is timed in bf16 at qwen's prefill
   [128, 256, 64] (and in fp32 there, the INT8 path's prefill, entry
   ``fp32``), at head dim 128 ([256, 2048, 128] causal, entry
   ``d128``) and at the hybrid's shape below, each beside SDPA. The
   short calls (decode ``quant_matmul``, qwen's, the int8 and the
   shared-prefix ``flash_attention``, the int8 ``paged_attention``),
   ``rglru_scan`` and
   ``mlstm_chunkwise`` also give ``device_ms``: one call's device time,
   calls captured in a CUDA graph, beside the library's or yardstick's.
   The INT8 kernels (``quant_matmul``, the int8 body of
   ``paged_attention``: table ``PQ8_CASES``, the INT8 slot grid, GQA on
   pages of 16, phase 4f's pool of pages of 64 with rows over several
   chunks, MQA at head dim 256) are checked the same way, with q/x in
   fp32 (the INT8 path's activations) and bf16. ``quant_matmul``'s
   library call is
   ``torch._weight_int8pack_mm`` on the weight transposed ahead of time
   (or the error it raises); no PyTorch call computes the int8 attention
   body. Their labelled yardsticks are ``torch.matmul`` on a weight
   dequantised ahead of time and SDPA over pre-dequantised K/V.
   Then the kernels at recurrentgemma-2b's shapes: ``rglru_scan`` (table
   ``RG_CASES``: fp32 and bf16 [8, 2048, 2560] and [1, 2048, 2560], both
   timed in fp32 with their device time, a ragged [3, 37, 2560], an
   identity-step tail and a width off 16 bytes that takes the rows route;
   bit-equal to its plain version and on two calls, its launch plan
   printed; no PyTorch call computes a linear recurrence, so its
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
   m) against the plain version (in bf16 its mirror of the tensor-core
   kernel, ``ref.mlstm_chunkwise_ref(split=True)``), also at head dims
   96, 256 and 384 (the other tensor-core instances); no PyTorch call
   computes the mLSTM, so its library time is null. Then the multi-query
   form of ``paged_attention`` (the speculative verify; table
   ``PA_MULTI_CASES``: qwen's grid with lengths 1-512, the last ones
   clamped, phase 4f's pool of pages of 64 and GQA on pages of 16, at S
   = 2, 5 and 8, fp32 and bf16, bit-stable), timed in bf16 at S = 5
   beside S launches of the one-query form and masked SDPA with a [B, H,
   S, T] mask (the kernel line's ``multi_query`` entry of
   ``paged_attention``), and ``xfer_matmul`` at the verify's R = 40 for
   qwen's projections and unembedding. Then ``xfer_matmul_experts``
   (table ``EXPERT_CASES``): deepseek-moe-16b's expert products
   [64, C, 2048] @ [64, 2048, 1408] and [64, C, 1408] @ [64, 1408, 2048]
   at C = 1, 60 and 240 plus ragged and split-K shapes, fp32 and bf16,
   bit-stable, timed in bf16 beside ``torch.bmm`` and 64 launches of
   ``xfer_matmul``. Head dim 128: ``paged_attention`` on deepseek's grid
   [8, 512, 16, 128] and yi-9b's [8, 512, 4, 128] with 32 query heads
   (entries ``d128``, ``d128_gqa``), ``flash_attention`` at yi-9b's
   prefill [256, 512, 128] (entry ``d128_gqa``);
4. full-width qwen1.5-0.5b served greedily in bf16 through
   ``ServingEngine.run_until_drained()``, whose decode step replays one
   CUDA graph captured when the engine is built (phases 4-4f alike; a
   replay adds its capture's launches to the counters): the fp kernels'
   launch counters must rise by their per-step counts, the INT8 ones
   stay 0;
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
4e/4f. qwen1.5-0.5b on the paged pool, bf16 and INT8 (see
   ``serve_paged``);
4h. speculative serving (``serve_spec``): full-width qwen1.5-0.5b with a
   1-layer draft of its widths, k = 4, on the grid (phase 4's prompts)
   and the paged pool (phase 4e's shared set), 32 new tokens each;
   launch counts exact (each replay 5 draft forwards and one verify),
   step p50, tokens/s, ``accepted_tokens_mean``, ``draft_acceptance``
   and peak bytes beside phase 4's target-only numbers;
4i. sampled serving (``serve_sampled``): phase 4's traffic with top-k
   (k 50, T 0.8) and with temperature (T 0.8); launch counts exact, and
   every slot's key after the drain equal to the host's threefry chain
   of its last request; step p50 beside greedy's;
4j. deepseek-moe-16b at full width and depth in bf16 (``serve_moe``):
   phase 4's 16 prompts on the slot grid, then on the page pool (pages
   of 64, no prefix registry) on the same weights; launches exactly
   ``pass_launches`` per decode step and prefill group (224
   ``xfer_matmul``, 81 ``xfer_matmul_experts``, 28 attention), every
   request to its budget; step p50/p95, admission p50, tokens/s, peak
   allocated bytes and the step's byte bound printed;
4k. the same for minitron-8b (relu2, full depth), yi-9b and
   phi3-medium-14b (full width, 8 layers), one model at a time on the
   grid (``serve_dense_d128``);
4g. the captured step against the eager one on twelve paths (fp, INT8,
   paged fp and int8 pools, hybrid, ssm, top-k sampling, speculative on
   the grid and on the pool, deepseek-moe-16b on the grid and the pool,
   minitron-8b; full width, 8 slots): after one
   admission, 16 eager steps of ``registry.build_serve_step`` on a clone
   of caches and state and 16 replays on the originals give equal
   records and bit-equal caches and state, and each replay counts its
   capture's launches; then 20 steady qwen steps through
   ``ServingEngine.step()`` traced with ``torch.profiler``, replaying
   the graph, then dispatching the eager step, then replaying a
   speculative engine's step (k = 4, the 1-layer draft), then 20 steady
   steps of full-size deepseek-moe-16b's captured step: the device's idle
   share of each window, its top device ops and the launches a step
   that are not the hand-written kernels';
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
5e. the paged pool, card vs CPU (see ``parity_paged``);
5f. speculative and sampled streams, card vs CPU (see ``parity_spec``):
   qwen1.5-0.5b at full width, depth 4, a 1-layer draft, k = 3, fp32, on
   the grid and the pool: greedy and top-k spec streams equal the CPU
   port's, greedy spec (and a self-draft's) equal target-only on the
   card;
5g. deepseek-moe-16b at full width cut to 3 layers (its dense prefix
   layer and 2 MoE layers, capacity factor 1.25: assignments drop) and
   minitron-8b at full width cut to 2, seeded fp32 weights, card vs CPU
   (``parity_moe``): logits within 2e-3, greedy tokens equal (a flip
   only under a top-2 margin of 2e-3), each position's smallest router
   margin printed;
6. the kernel table as one JSON line, then the result line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# dense peaks: bf16 products on the tensor cores; fp32 FMA off them (the
# CUDA-core kernels)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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
# phases 3-q8, 4e, 4f and 5e: qwen1.5-0.5b's page pool, pages of 64
# tokens; the shared set is one 200-token system prompt (3 pages and 8
# tokens) as the owner's prompt and 15 prompts of it plus a tail of
# 8-120 tokens
PAGE, SYS_LEN, TAIL_RANGE, N_SHARERS = 64, 200, (8, 120), 15
SOURCES = {
    "xfer_matmul": ("src/repro_torch/kernels/csrc/xfer_matmul.cu",
                    "src/repro/kernels/xfer_matmul.py:22"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
    "flash_attention_q8": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:73"),
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
    # no TPU kernel: the reference's expert products are jnp.einsum in
    # _expert_ffn, which is the line named
    "xfer_matmul_experts": ("src/repro_torch/kernels/csrc/xfer_matmul.cu",
                            "src/repro/models/blocks.py:550"),
}
# the kernels each serving path runs (phase 4: fp, phase 4b: INT8,
# phase 4c: the hybrid, phase 4d: the ssm family, phase 4e: paged, phase
# 4f: paged under INT8 with int8 pools, phase 4h: speculative on the grid
# and the pool (the multi-query paged_attention), phase 4i: sampled); a
# kernel's main path is the first that runs it
PATH_KERNELS = {"fp": ("xfer_matmul", "flash_attention", "paged_attention"),
                "int8": ("quant_matmul", "flash_attention",
                         "paged_attention_q8"),
                "hybrid": ("xfer_matmul", "flash_attention", "paged_attention",
                           "rglru_scan"),
                "ssm": ("xfer_matmul", "mlstm_chunkwise"),
                "paged": ("xfer_matmul", "flash_attention", "paged_attention"),
                "paged-int8": ("quant_matmul", "flash_attention",
                               "flash_attention_q8", "paged_attention_q8"),
                "spec": ("xfer_matmul", "flash_attention", "paged_attention"),
                "spec-paged": ("xfer_matmul", "flash_attention",
                               "paged_attention"),
                "sampled": ("xfer_matmul", "flash_attention",
                            "paged_attention"),
                "moe": ("xfer_matmul", "xfer_matmul_experts",
                        "flash_attention", "paged_attention"),
                "moe-paged": ("xfer_matmul", "xfer_matmul_experts",
                              "flash_attention", "paged_attention"),
                "dense-d128": ("xfer_matmul", "flash_attention",
                               "paged_attention")}


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed under CUDA events, so that the host's
    launch path is out of the loop (an eager loop of calls of 0.01-0.03
    ms times that path as much as the card)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, 10, 2) / calls
    del graph
    return ms


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def term_products(a: str, b: str) -> int:
    """bf16 tensor-core products that the flash kernels take for one
    product of operands in ``a`` and ``b``: an fp32 operand is three
    exact bf16 terms, a bf16 or int8 one is one; of two split operands
    the term pairs i + j < 3."""
    na, nb = (3 if x == "float32" else 1 for x in (a, b))
    return 6 if na == nb == 3 else na * nb


def flash_bound(nbytes: float, parts, dt, d: int, prefix_q8: bool = False,
                main_q8: bool = False):
    """``bound_ms`` of a flash_attention call (q in ``dt``, head dim
    ``d``) on the unit its kernel runs on. ``parts``: (flops, q dtype,
    k/v storage) of each key segment. ``flash_tc_kernel`` and
    ``flash_terms_kernel`` take ``term_products`` bf16 products at the
    bf16 peak for each product of the function; the CUDA-core
    ``flash_split_kernel`` runs fp32 FMA at the fp32 peak."""
    from repro_torch.kernels.flash_attention import kernel_for
    if kernel_for(dt, d, prefix_q8, main_q8) == "flash_split_kernel":
        return bound_ms(nbytes, sum(f for f, _, _ in parts), "float32")
    return bound_ms(nbytes, sum(f * term_products(a, b) for f, a, b in parts),
                    "bfloat16")


def compare(name: str, got, want, dtype: str) -> float:
    """Each element within ``tol`` of its own magnitude plus the RMS of
    its row (last axis) of ``want``: the error is held to the output's
    scale, so a zeroed or unmasked row of small values fails, and a
    row of large values is not held below fp32's resolution. A NaN or an
    infinity in ``got`` fails."""
    import torch
    torch.cuda.synchronize()
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    tol = TOL[dtype]
    bad = ~(err <= tol * (want.abs() + rms))
    max_err = float(err.max())
    if bool(bad.any()):
        worst = float((err / (want.abs() + rms)).max())
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {max_err:.3e}, {int(bad.sum())} "
                             f"elements off, worst err / (|want| + row RMS) "
                             f"{worst:.3e}, tol {tol})")
    return max_err


def bit_stable(name: str, first, second) -> None:
    """Two calls on the same inputs give bit-equal outputs: the kernels
    that reduce across blocks do so in a fixed order, without float
    atomics."""
    import torch
    if not torch.equal(first, second):
        diff = float((first.float() - second.float()).abs().max())
        raise AssertionError(f"{name}: two calls on the same inputs differ "
                             f"(max {diff:.3e})")


def iters_for(flops: float):
    """(timed iterations, warm-up calls): fewer for a case of 1e11 flops
    and more."""
    return (20, 3) if flops < 1e11 else (3, 1)


def record(entries: dict, name: str, entry, row: dict) -> None:
    """Keep a timed case as the kernel's entry: ``main`` for the first
    serving path that runs the kernel, ``hybrid``, ``ssm``, ``d128``,
    ``pool`` or ``fp32`` as a sub-entry of that name."""
    if entry == "main":
        entries.setdefault(name, {}).update(row)
    elif entry in ("hybrid", "ssm", "d128", "d128_gqa", "pool", "fp32"):
        entries.setdefault(name, {})[entry] = row


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# --------------------------------------------------------------------------

BOTH, FP32, BF16 = ("float32", "bfloat16"), ("float32",), ("bfloat16",)
# qwen1.5-0.5b (phases 4, 4b) and recurrentgemma-2b (phase 4c) widths
Q_D, Q_FF, Q_VOCAB, Q_HEADS = 1024, 2816, 151936, 16
H_FF, H_VOCAB = 7680, 256000
X_D, X_VOCAB = 1024, 50304  # xlstm-350m (phase 4d)
# deepseek-moe-16b (phases 4j, 5g): 64 routed experts of width 1408 over
# d 2048, top 6, 16 heads of 128; yi-9b (phase 4k): 32 heads over 4 KV
M_E, M_D, M_FF, M_TOPK, M_HEADS = 64, 2048, 1408, 6, 16
Y_HEADS, Y_KV = 32, 4

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
    ("non-causal BH=3 S=50 D=256", 3, 50, 256, 0, False, BOTH, False, None),
    # head dim 128 (the MoE and dense models of phases 4j/4k): timed in
    # bf16 beside SDPA; yi-9b's prefill of 8 prompts of a 512 bucket, 32
    # query heads over 4 KV groups (layers.attention repeats K/V per
    # group and folds the heads into the batch: BH = 8 x 32)
    ("BH=256 S=2048 D=128", 256, 2048, 128, 0, True, BF16, True, "d128"),
    (f"BH={SLOTS * Y_HEADS} S={MAX_LEN} D=128 (yi-9b prefill, GQA "
     f"{Y_HEADS}/{Y_KV})", SLOTS * Y_HEADS, MAX_LEN, 128, 0, True, BF16,
     True, "d128_gqa"),
    ("ragged BH=4 S=150 D=128 window 40", 4, 150, 128, 40, True, BOTH, False,
     None),
    ("BH=3 S=70 D=16", 3, 70, 16, 0, True, BOTH, False, None),
    ("non-causal BH=2 S=90 D=32 window 20", 2, 90, 32, 20, False, BOTH,
     False, None)]
# and with more keys than queries, non-causal: (label, BH, S, T, D)
FA_KV_CASES = [("non-causal BH=3 S=40 T=150 D=128", 3, 40, 150, 128),
               ("non-causal BH=2 S=70 T=200 D=256", 2, 70, 200, 256)]

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
     [1, 40, 5 * 16], False, None),
    # head dim 128: deepseek-moe-16b's grid (MHA, 16 heads) and yi-9b's
    # (32 query heads over 4 KV heads, 8 per group)
    (f"grid q[{SLOTS},{M_HEADS},128] pool[{SLOTS},{MAX_LEN},{M_HEADS},128]",
     SLOTS, M_HEADS, M_HEADS, 128, (SLOTS, MAX_LEN), None,
     [1, 17, 64, 128, 129, 200, 233, MAX_LEN], True, "d128"),
    (f"grid q[{SLOTS},{Y_HEADS},128] pool[{SLOTS},{MAX_LEN},{Y_KV},128]",
     SLOTS, Y_HEADS, Y_KV, 128, (SLOTS, MAX_LEN), None,
     [1, 17, 64, 128, 129, 200, 233, MAX_LEN], True, "d128_gqa"),
    ("ragged D=128 H=40 G=10 ps=64", 3, 40, 10, 128, (3 * 8 + 2, 64), 8,
     [1, 300, 8 * 64], False, None)]


# paged_attention's multi-query form (the speculative verify of k + 1
# positions): (label, B, H, G, D, (pages, page size), table columns
# (None: the dense grid through an identity table), first-query lengths,
# entry); every case at S in SPEC_S, in fp32 and bf16. qwen's grid (a
# length of 509 runs its last queries into the clamp at 512), phase 4f's
# pool (pages of 64, 65 pages, rows over several 128-position chunks) and
# GQA on pages of 16
SPEC_S = (2, 5, 8)
SPEC_K = 4  # phases 4h and 4g: k = 4 proposals, a verify of S = 5
PA_MULTI_CASES = [
    (f"grid q[{SLOTS},S,{Q_HEADS},64] grid[{SLOTS},{MAX_LEN},{Q_HEADS},64]",
     SLOTS, Q_HEADS, Q_HEADS, 64, (SLOTS, MAX_LEN), None,
     [1, 17, 64, 128, 129, 200, 509, MAX_LEN], "main"),
    (f"pool q[{SLOTS},S,{Q_HEADS},64] pool[65,{PAGE},{Q_HEADS},64] table "
     f"{SLOTS}x{MAX_LEN // PAGE}", SLOTS,
     Q_HEADS, Q_HEADS, 64, (65, PAGE), MAX_LEN // PAGE,
     [1, 63, 64, 65, 300, 447, 505, MAX_LEN], "pool"),
    ("GQA H=8 G=2 ps=16", 3, 8, 2, 64, (3 * 9 + 2, 16), 9, [1, 77, 140],
     None)]
# xfer_matmul at the verify's rows, R = slots x (k + 1) = 40: qwen's
# projections (wq, wk, wv, wo; w_gate, w_up; w_down) and the unembedding
VERIFY_R = SLOTS * (SPEC_K + 1)
VERIFY_MM = ((Q_D, Q_D, False), (Q_D, Q_FF, False), (Q_FF, Q_D, False),
             (Q_D, Q_VOCAB, True))


def check_paged_multi(dev, gen, entries: dict) -> None:
    """Phase 3, the multi-query ``paged_attention`` (PA_MULTI_CASES at
    every S of SPEC_S): against its plain version (one query position at
    a time, ``ref.paged_attention_ref``) and bit-stable on two calls.
    Timed in bf16 at S = SPEC_K + 1: the kernel (eager loop and device
    time), S launches of the one-query form (yardstick), masked SDPA with
    a [B, H, S, T] mask (library yardstick, the grid only) and the byte
    bound (each valid K/V row read once). Then ``xfer_matmul`` at the
    verify's R = 40 (VERIFY_MM). Keeps the timed grid case as the
    ``paged_attention`` entry's ``multi_query``, the pool's under it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.xfer_matmul import route as xfer_route

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    multi = {}
    for (label, b, h, g, d, (n_pages, ps), m, lengths,
         entry) in PA_MULTI_CASES:
        for dname, dt in dtypes.items():
            kp = randn(n_pages, ps, g, d, dt=dt)
            vp = randn(n_pages, ps, g, d, dt=dt)
            if m is None:  # the dense grid: one page per row
                tb = torch.arange(b, device=dev, dtype=torch.int32)[:, None]
            else:
                perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
                tb = perm[:b * m].reshape(b, m).to(torch.int32)
            t = tb.shape[1] * ps
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            for s in SPEC_S:
                q = randn(b, s, h, d, dt=dt)
                got = ops.paged_attn(q, kp, vp, tb, lens)
                err = compare(f"paged_attention S={s} {label} {dname}", got,
                              ops.paged_attn_ref(q, kp, vp, tb, lens), dname)
                bit_stable(f"paged_attention S={s} {label} {dname}", got,
                           ops.paged_attn(q, kp, vp, tb, lens))
                line = (f"[kernel] paged_attention S={s} {label} {dname}: "
                        f"max_abs_err {err:.3e}")
                if not (dname == "bfloat16" and s == SPEC_K + 1 and entry):
                    log(line)
                    continue
                esz = q.element_size()
                kv_rows = sum(min(n + s - 1, t) for n in lengths)
                pairs = sum(min(n + j, t) for n in lengths for j in range(s))
                nb, kind = bound_ms(2 * q.numel() * esz
                                    + 2 * kv_rows * g * d * esz
                                    + tb.numel() * 4 + lens.numel() * 4,
                                    4.0 * h * d * pairs, dname)
                lens_j = [torch.clamp(lens + j, max=t) for j in range(s)]

                def one_query_each():
                    for j in range(s):
                        ops.paged_attn(q[:, j], kp, vp, tb, lens_j[j])

                ms = time_ms(lambda: ops.paged_attn(q, kp, vp, tb, lens))
                dev_ms = graph_ms(lambda: ops.paged_attn(q, kp, vp, tb, lens))
                plain = time_ms(lambda: ops.paged_attn_ref(q, kp, vp, tb, lens))
                yard = time_ms(one_query_each)
                yard_dev = graph_ms(one_query_each)
                row = dict(shape=f"{label}, S={s}, lengths {lengths} bf16",
                           S=s, max_abs_err=err, ms=ms, device_ms=dev_ms,
                           plain_ms=plain, bound_ms=nb, bound_by=kind,
                           yardstick="S launches of the one-query form",
                           yardstick_ms=yard, yardstick_device_ms=yard_dev,
                           library_ms=None)
                line += (f" ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms "
                         f"{plain:.4f} bound_ms {nb:.4f} ({kind}); {s} "
                         f"one-query launches {yard:.4f} ms, device "
                         f"{yard_dev:.4f}")
                if m is None:  # SDPA over the grid, [B, H, S, T] mask
                    q4 = q.permute(0, 2, 1, 3)
                    k4, v4 = kp.permute(0, 2, 1, 3), vp.permute(0, 2, 1, 3)
                    lim = torch.clamp(lens[:, None] + torch.arange(
                        s, device=dev)[None], max=t)
                    mask = (torch.arange(t, device=dev)[None, None]
                            < lim[:, :, None])[:, None]
                    lib = time_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask, enable_gqa=h != g))
                    row["library_ms"] = lib
                    row["library_device_ms"] = graph_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=mask, enable_gqa=h != g))
                    line += (f"; library_ms {lib:.4f} (SDPA, [B,H,S,T] mask),"
                             f" device {row['library_device_ms']:.4f}")
                log(line)
                if entry == "main":
                    multi.update(row)
                else:
                    multi[entry] = row
                del q, got
            del kp, vp
    entries["paged_attention"]["multi_query"] = multi

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = entries["xfer_matmul"]["shapes"]
    for n, m, transposed in VERIFY_MM:
        x = randn(VERIFY_R, n, dt=torch.bfloat16)
        if transposed:
            w = randn(m, n, dt=torch.bfloat16, scale=n ** -0.5).T
        else:
            w = randn(n, m, dt=torch.bfloat16, scale=n ** -0.5)
        rt = xfer_route(VERIFY_R, n, m, torch.bfloat16, w.stride(), sms)
        got = ops.matmul(x, w)
        label = f"verify R={VERIFY_R} {n}x{m}" + (" (embed.T)" if transposed
                                                   else "")
        err = compare(f"xfer_matmul {label}", got, ops.matmul_ref(x, w),
                      "bfloat16")
        bit_stable(f"xfer_matmul {label}", got, ops.matmul(x, w))
        flops = 2.0 * VERIFY_R * n * m
        ms = time_ms(lambda: ops.matmul(x, w))
        dev_ms = graph_ms(lambda: ops.matmul(x, w))
        plain = time_ms(lambda: ops.matmul_ref(x, w))
        lib = time_ms(lambda: torch.matmul(x, w))
        b, kind = bound_ms((VERIFY_R * n + n * m + VERIFY_R * m) * 2, flops,
                           "bfloat16")
        log(f"[kernel] xfer_matmul {label} bfloat16: route {rt.kernel} grid "
            f"{rt.grid} splits {rt.splits}; max_abs_err {err:.3e} ms {ms:.4f} "
            f"device_ms {dev_ms:.4f} plain_ms {plain:.4f} library_ms "
            f"{lib:.4f} bound_ms {b:.4f} ({kind}) kernel/library "
            f"{ms / lib:.2f}")
        shapes.append(dict(shape=f"x[{VERIFY_R},{n}] @ "
                                 f"{'embed.T' if transposed else 'w'}[{n},{m}]"
                                 f" bf16 (verify)",
                           variant=rt.kernel, max_abs_err=err, ms=ms,
                           device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                           bound_by=kind, library_ms=lib))
        del x, w, got


# xfer_matmul_experts (the MoE layer's expert products, one launch): (label,
# E, C, K, N, dtypes, timed in bf16, entry). deepseek-moe-16b's w_gate /
# w_up ([64, 2048, 1408]) and w_down ([64, 1408, 2048]) at C = 1 (decode
# at 8 slots: cap = ceil(8 x 6 / 64 x 1.25)), 60 (one 512-token bucket)
# and 240 (2048 tokens); then ragged shapes and split-K ones, so that
# every body's per-expert workspace and counters are reached
EXPERT_CASES = (
    [(f"[{M_E},{c},{k}] @ [{M_E},{k},{n}]", M_E, c, k, n, BOTH, True,
      "main" if (c, k) == (1, M_D) else None)
     for c in (1, 60, 240) for k, n in ((M_D, M_FF), (M_FF, M_D))]
    + [("ragged E=5 C=13 1000x1001", 5, 13, 1000, 1001, BOTH, False, None),
       ("ragged E=3 C=77 1000x1001", 3, 77, 1000, 1001, BOTH, False, None),
       ("E=4 C=17 512x256", 4, 17, 512, 256, BOTH, False, None),
       ("E=7 C=16 256x128", 7, 16, 256, 128, BOTH, False, None),
       ("split-K E=2 C=9 4096x64", 2, 9, 4096, 64, BOTH, False, None),
       ("split-K E=2 C=40 4096x256", 2, 40, 4096, 256, BOTH, False, None)])


def check_experts(dev, gen) -> dict:
    """``xfer_matmul_experts`` on every case of EXPERT_CASES against its
    plain version (``ref.expert_matmul_ref``, an fp32 einsum over E), two
    calls bit-equal, the route of each expert's product printed; the
    timed cases in bf16 beside ``torch.bmm`` (library) and E launches of
    the dense ``xfer_matmul`` (yardstick), eager and as device time from
    a CUDA graph."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.xfer_matmul import route as xfer_route

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    entry_rows, shapes = {}, []
    for label, e, c, k, n, dnames, timed, entry in EXPERT_CASES:
        for dname in dnames:
            dt = dtypes[dname]
            x = (torch.randn(e, c, k, generator=gen, device=dev)).to(dt)
            w = (torch.randn(e, k, n, generator=gen, device=dev)
                 * k ** -0.5).to(dt)
            rt = xfer_route(c, k, n, dt, (n, 1), sms, experts=e)
            got = ops.expert_matmul(x, w)
            err = compare(f"xfer_matmul_experts {label} {dname}", got,
                          ops.expert_matmul_ref(x, w), dname)
            bit_stable(f"xfer_matmul_experts {label} {dname}", got,
                       ops.expert_matmul(x, w))
            line = (f"[kernel] xfer_matmul_experts {label} {dname}: route "
                    f"{rt.kernel} grid {rt.grid} x {e} experts splits "
                    f"{rt.splits}; max_abs_err {err:.3e} (bit-stable)")
            if timed and dname == "bfloat16":
                flops = 2.0 * e * c * k * n
                it, wu = iters_for(flops)

                def dense_loop():
                    for i in range(e):
                        ops.matmul(x[i], w[i])

                ms = time_ms(lambda: ops.expert_matmul(x, w), it, wu)
                dev_ms = graph_ms(lambda: ops.expert_matmul(x, w))
                plain = time_ms(lambda: ops.expert_matmul_ref(x, w), it, wu)
                lib = time_ms(lambda: torch.bmm(x, w), it, wu)
                lib_dev = graph_ms(lambda: torch.bmm(x, w))
                yard = time_ms(dense_loop, it, wu)
                yard_dev = graph_ms(dense_loop, calls=2)
                b, kind = bound_ms((e * c * k + e * k * n + e * c * n)
                                   * x.element_size(), flops, dname)
                line += (f" ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms "
                         f"{plain:.4f} library_ms {lib:.4f} (torch.bmm; device "
                         f"{lib_dev:.4f}) yardstick_ms {yard:.4f} ({e} "
                         f"xfer_matmul launches; device {yard_dev:.4f}) "
                         f"bound_ms {b:.4f} ({kind}, {flops:.4e} flops) "
                         f"kernel/library {ms / lib:.2f}")
                row = dict(shape=f"x[{e},{c},{k}] @ w[{e},{k},{n}] bf16",
                           variant=rt.kernel, max_abs_err=err, ms=ms,
                           device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                           bound_by=kind, library_ms=lib,
                           library_device_ms=lib_dev, yardstick_ms=yard,
                           yardstick_device_ms=yard_dev,
                           yardstick=f"{e} launches of xfer_matmul",
                           bit_stable=True)
                shapes.append(row)
                if entry == "main":
                    entry_rows.update(row)
            log(line)
            del x, w, got
    entry_rows["shapes"] = shapes
    entry_rows["note"] = ("no TPU kernel: the reference's expert products "
                          "are jnp.einsum in _expert_ffn")
    return {"xfer_matmul_experts": entry_rows}


def check_kernels(dev) -> dict:
    """Checks every case of the tables above, ``quant_matmul``, the int8
    ``paged_attention`` body and ``rglru_scan``; prints every case and
    returns the timed entry per kernel (and its ``hybrid`` sub-entry)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.xfer_matmul import route as xfer_route

    flash_table = ptxas_kernels(build.build_log.get("flash_attention", ""))
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries = {}

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    def times(fn, plain, lib, flops):
        it, wu = iters_for(flops)
        return (time_ms(fn, it, wu), time_ms(plain, it, wu),
                time_ms(lib, it, wu))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = entries.setdefault("xfer_matmul", {}).setdefault("shapes", [])
    for label, r, n, m, transposed, dnames, timed, entry in MM_CASES:
        for dname in dnames:
            dt = dtypes[dname]
            x = randn(r, n, dt=dt)
            if transposed:
                w = randn(m, n, dt=dt, scale=n ** -0.5).T  # strided view
            else:
                w = randn(n, m, dt=dt, scale=n ** -0.5)
            rt = xfer_route(r, n, m, dt, w.stride(), sms)
            got = ops.matmul(x, w)
            err = compare(f"xfer_matmul {label} {dname}", got,
                          ops.matmul_ref(x, w), dname)
            bit_stable(f"xfer_matmul {label} {dname}", got, ops.matmul(x, w))
            line = (f"[kernel] xfer_matmul {label} {dname}: route {rt.kernel} "
                    f"grid {rt.grid} splits {rt.splits}; max_abs_err {err:.3e}")
            if timed and dname == "bfloat16":
                flops = 2.0 * r * n * m
                ms, plain, lib = times(lambda: ops.matmul(x, w),
                                       lambda: ops.matmul_ref(x, w),
                                       lambda: torch.matmul(x, w), flops)
                dev_ms = graph_ms(lambda: ops.matmul(x, w))
                b, kind = bound_ms((r * n + n * m + r * m) * x.element_size(),
                                   flops, dname)
                line += (f" ms {ms:.4f} device_ms {dev_ms:.4f} plain_ms "
                         f"{plain:.4f} library_ms {lib:.4f} bound_ms {b:.4f} "
                         f"({kind}) kernel/library {ms / lib:.2f}")
                row = dict(shape=f"x[{r},{n}] @ {'embed.T' if transposed else 'w'}"
                                 f"[{n},{m}] bf16",
                           variant=rt.kernel, max_abs_err=err, ms=ms,
                           device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                           bound_by=kind, library_ms=lib)
                shapes.append(row)
                record(entries, "xfer_matmul", entry, row)
            log(line)
            del x, w, got

    for label, bh, s, d, window, causal, dnames, timed, entry in FA_CASES:
        for dname in dnames:
            q, k, v = (randn(bh, s, d, dt=dtypes[dname]) for _ in range(3))
            got = ops.attention(q, k, v, causal=causal, window=window)
            want = ops.attention_ref(q, k, v, causal=causal, window=window)
            err = compare(f"flash_attention {label} {dname}", got, want, dname)
            bit_stable(f"flash_attention {label} {dname}", got,
                       ops.attention(q, k, v, causal=causal, window=window))
            del want
            note = ptxas_note(flash_table, flash_instance(dtypes[dname], d))
            line = (f"[kernel] flash_attention {label} {dname}: max_abs_err "
                    f"{err:.3e}; {note}")
            # timed: bf16 cases, and fp32 at the main shape (the INT8
            # path's prefill, against fp32 SDPA) as the sub-entry fp32
            if timed and (dname == "bfloat16" or entry == "main"):
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
                b, kind = flash_bound(4 * bh * s * d * q.element_size(),
                                      [(4.0 * d * pairs, dname, dname)],
                                      q.dtype, d)
                lib_note = " (SDPA, window mask)" if window else ""
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                         f"{lib:.4f}{lib_note} bound_ms {b:.4f} ({kind}) "
                         f"kernel/library {ms / lib:.2f}")
                win = f" window {window}" if window else ""
                row = dict(shape=f"q,k,v[{bh},{s},{d}] causal{win} {dname}",
                           max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=b, bound_by=kind, library_ms=lib,
                           ptxas=note)
                if entry == "main":  # a short call: its device time too
                    row["device_ms"] = graph_ms(
                        lambda: ops.attention(q, k, v, window=window))
                    row["library_device_ms"] = graph_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, is_causal=True))
                    line += (f"; device_ms {row['device_ms']:.4f} "
                             f"library_device_ms "
                             f"{row['library_device_ms']:.4f} (CUDA graph)")
                record(entries, "flash_attention",
                       entry if dname == "bfloat16" else "fp32", row)
            log(line)
            del q, k, v, got
    for label, bh, s, t, d in FA_KV_CASES:
        for dname, dt in dtypes.items():
            q = randn(bh, s, d, dt=dt)
            k, v = randn(bh, t, d, dt=dt), randn(bh, t, d, dt=dt)
            err = compare(f"flash_attention {label} {dname}",
                          ops.attention(q, k, v, causal=False),
                          ops.attention_ref(q, k, v, causal=False), dname)
            log(f"[kernel] flash_attention {label} {dname}: max_abs_err "
                f"{err:.3e}; {ptxas_note(flash_table, flash_instance(dt, d))}")

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
            bit_stable(f"paged_attention {label} {dname}", got,
                       ops.paged_attn(q, kp, vp, tb, lens))
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
                f"{lib:.4f}{lib_note} bound_ms {nb:.4f} ({kind}) "
                f"kernel/library {ms / lib:.2f}")
            # every row at the full grid, as most decode steps run it
            full = torch.full_like(lens, t)
            full_ms = time_ms(lambda: ops.paged_attn(q, kp, vp, tb, full))
            full_lib = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, enable_gqa=h != g))
            full_nb, full_kind = bound(b * t)
            log(f"[kernel] paged_attention {label}, every length {t}, "
                f"{dname}: ms {full_ms:.4f} library_ms {full_lib:.4f} (SDPA, "
                f"no mask) bound_ms {full_nb:.4f} ({full_kind})")
            record(entries, "paged_attention", entry, dict(
                shape=f"q[{b},{h},{d}] grid[{b},{t},{g},{d}] lengths "
                      f"{lengths} bf16",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=nb,
                bound_by=kind, library_ms=lib, every_length=dict(
                    ms=full_ms, library_ms=full_lib, bound_ms=full_nb,
                    bound_by=full_kind)))
            del q, kp, vp, got, want
    check_paged_multi(dev, gen, entries)
    entries.update(check_experts(dev, gen))
    entries.update(check_int8_kernels(dev, gen))
    check_flash_q8(dev, gen, entries)
    entries.update(check_rglru(dev, gen))
    entries.update(check_mlstm(dev, gen))
    torch.cuda.empty_cache()
    return entries


# quant_matmul: (label, R, N, M, w_q given as q.T); every INT8 projection
# at decode (R = slots) and prefill rows, the tied unembedding
# (embed.q.T, unit scale), and ragged cases: two that the int8 streams
# take (rows on 16 bytes with a ragged column tile and split; a K-major
# ragged M) and two that go to tile
QM_CASES = (
    [(f"R={r} {n}x{m}", r, n, m, False)
     for r in (SLOTS, N_PREFILL * BUCKET)
     for n, m in ((Q_D, Q_D), (Q_D, Q_FF), (Q_FF, Q_D))]
    + [(f"R={SLOTS} {Q_D}x{Q_VOCAB} (embed.q.T)", SLOTS, Q_D, Q_VOCAB, True),
       ("ragged R=13 1000x1008", 13, 1000, 1008, False),
       ("ragged R=13 1024x1001 (q.T)", 13, 1024, 1001, True),
       ("ragged R=13 1000x1001", 13, 1000, 1001, False),
       ("ragged R=77 1000x1001 (q.T)", 77, 1000, 1001, True)])


# paged_attention's int8 body: (label, B, H, G, D, (pages, page size),
# table columns (None: the dense grid through an identity table),
# lengths, entry of the case timed in fp32 or None); the INT8 path's slot
# grid, GQA on pages of 16, phase 4f's pool (pages of 64, 65 pages, rows
# over several 128-position chunks), MQA at head dim 256
PQ8_CASES = [
    (f"grid q[{SLOTS},{Q_HEADS},64] int8 pool[{SLOTS},{MAX_LEN},{Q_HEADS},64]",
     SLOTS, Q_HEADS, Q_HEADS, 64, (SLOTS, MAX_LEN), None,
     [1, 17, 64, 128, 129, 200, 233, MAX_LEN], "main"),
    ("ragged GQA H=8 G=2 ps=16", 3, 8, 2, 64, (3 * 9 + 2, 16), 9,
     [1, 77, 9 * 16], None),
    (f"pool q[{SLOTS},{Q_HEADS},64] int8 pool[{SLOTS * MAX_LEN // PAGE + 1},"
     f"{PAGE},{Q_HEADS},64]", SLOTS, Q_HEADS, Q_HEADS, 64,
     (SLOTS * MAX_LEN // PAGE + 1, PAGE), MAX_LEN // PAGE,
     [1, 64, 65, 128, 129, 300, 450, MAX_LEN], "pool"),
    ("ragged MQA D=256 H=10 G=1 ps=16", 3, 10, 1, 256, (3 * 5 + 2, 16), 5,
     [1, 40, 5 * 16], None)]


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
    from repro_torch.kernels.quant_matmul import route as qm_route

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries = {}

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    # ---- quant_matmul: every projection + the tied unembedding (q.T)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for label, r, n, m, transposed in QM_CASES:
        if transposed:  # the unembedding: unit scale, q.T a strided view
            w = Q.quantize(randn(m, n, scale=n ** -0.5), axis=0)
            w_q, scale = w.q.T, torch.ones(1, m, device=dev)
        else:
            w = Q.quantize(randn(n, m, scale=n ** -0.5), axis=0)
            w_q, scale = w.q, w.scale
        w_deq = Q.dequantize(Q.QTensor(w_q, scale))
        for dname, dt in dtypes.items():
            x = randn(r, n, dt=dt)
            rt = qm_route(r, n, m, dt, w_q.stride(), sms,
                          aligned=w_q.data_ptr() % 16 == 0)
            got = ops.int8_matmul(x, w_q, scale)
            want = ops.int8_matmul_ref(x, w_q, scale)
            err = compare(f"quant_matmul {label} {dname}", got, want, dname)
            bit_stable(f"quant_matmul {label} {dname}", got,
                       ops.int8_matmul(x, w_q, scale))
            line = (f"[kernel] quant_matmul {label} {dname}: route {rt.kernel} "
                    f"grid {rt.grid} splits {rt.splits}; max_abs_err {err:.3e}")
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
                if lib is not None:
                    line += f" kernel/library {ms / lib:.2f}"
                row = dict(shape=f"x[{r},{n}] fp32 @ "
                                 f"{'embed.q.T' if transposed else 'w_q'}"
                                 f"[{n},{m}] int8",
                           variant=rt.kernel, max_abs_err=err, ms=ms,
                           plain_ms=plain, bound_ms=b, bound_by=kind,
                           library_ms=lib, yardstick_ms=yard)
                if r == SLOTS:  # decode: the device time of one call too
                    row["device_ms"] = graph_ms(
                        lambda: ops.int8_matmul(x, w_q, scale))
                    line += f"; device_ms {row['device_ms']:.4f}"
                    if lib is not None:
                        w_t = w_q.T.contiguous()
                        s8 = scale.reshape(-1).to(x.dtype)
                        row["library_device_ms"] = graph_ms(
                            lambda: torch._weight_int8pack_mm(x, w_t, s8))
                        line += (f" library_device_ms "
                                 f"{row['library_device_ms']:.4f}")
                        del w_t
                    line += " (CUDA graph)"
                if lib is None:
                    row["library_error"] = lib_note
                shapes.append(row)
                if r == SLOTS and m == Q_VOCAB:
                    entries["quant_matmul"] = dict(
                        row, yardstick="torch.matmul on the pre-dequantised "
                                       "weight")
            log(line)
        del x, got, want, w, w_q, w_deq
    entries["quant_matmul"]["shapes"] = shapes

    # ---- paged_attention int8 body: every case of PQ8_CASES, q in fp32
    # (the INT8 path's) and bf16
    for label, b, h, g, d, (n_pages, ps), m, lengths, entry in PQ8_CASES:
        kq = Q.quantize_kv(randn(n_pages, ps, g, d))
        vq = Q.quantize_kv(randn(n_pages, ps, g, d))
        if m is None:  # the dense grid: one page per row
            tb = torch.arange(b, device=dev, dtype=torch.int32)[:, None]
        else:
            perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
            tb = perm[:b * m].reshape(b, m).to(torch.int32)
        lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
        scales = dict(k_scale=kq.scale, v_scale=vq.scale)
        for dname, dt in dtypes.items():
            q = randn(b, h, d, dt=dt)
            args = (q, kq.q, vq.q, tb, lens)
            got = ops.paged_attn(*args, **scales)
            want = ops.paged_attn_ref(*args, **scales)
            err = compare(f"paged_attention_q8 {label} {dname}", got, want, dname)
            bit_stable(f"paged_attention_q8 {label} {dname}", got,
                       ops.paged_attn(*args, **scales))
            line = (f"[kernel] paged_attention_q8 {label} {dname}: max_abs_err "
                    f"{err:.3e} (bit-stable)")
            if entry and dname == "float32":
                t = tb.shape[1] * ps
                ms = time_ms(lambda: ops.paged_attn(*args, **scales))
                dms = graph_ms(lambda: ops.paged_attn(*args, **scales))
                plain = time_ms(lambda: ops.paged_attn_ref(*args, **scales))
                # yardstick: SDPA over K/V dequantised ahead of time (the
                # grid's rows in table order)
                rows = tb.long()
                q4 = q[:, :, None, :]
                k4, v4 = (Q.dequantize(x)[rows].reshape(b, t, g, d)
                          .permute(0, 2, 1, 3) for x in (kq, vq))
                mask = (torch.arange(t, device=dev)[None] < lens[:, None])
                mask = mask[:, None, None, :]

                def yard():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask, enable_gqa=h != g)

                yms, ydms = time_ms(yard), graph_ms(yard)
                tokens = sum(lengths)
                nbytes = (2 * q.numel() * 4 + tokens * g * (2 * d + 2 * 4)
                          + tb.numel() * 4 + lens.numel() * 4)
                nb, kind = bound_ms(nbytes, 4.0 * h * d * tokens, dname)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} yardstick_ms "
                         f"{yms:.4f} (SDPA over pre-dequantised K/V, masked) "
                         f"bound_ms {nb:.4f} ({kind}); device_ms {dms:.4f} "
                         f"yardstick_device_ms {ydms:.4f} (CUDA graph) "
                         f"kernel/yardstick {ms / yms:.2f}")
                row = dict(
                    bit_stable=True, shape=f"q[{b},{h},{d}] fp32 int8 "
                          f"{'grid' if m is None else 'pool'}"
                          f"[{n_pages},{ps},{g},{d}] table {tuple(tb.shape)} "
                          f"lengths {lengths}",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=nb,
                    bound_by=kind, library_ms=None, yardstick_ms=yms,
                    yardstick="SDPA over pre-dequantised K/V",
                    device_ms=dms, yardstick_device_ms=ydms)
                record(entries, "paged_attention_q8", entry, row)
                del k4, v4
            log(line)
            del q, got, want
        del kq, vq
    return entries


# rglru_scan: (label, (B, S, W), identity-step tail, timed in fp32,
# entry); every case in fp32 and bf16. The first two are the RG-LRU
# prefill of a full 8-slot group and of one row; the identity tail is a
# right-padded prompt's (a, b) = (1, 0); W = 1001 takes the rows route
RG_CASES = [
    (f"[{H_SLOTS},{H_WINDOW},{H_WIDTH}]", (H_SLOTS, H_WINDOW, H_WIDTH), 0,
     True, "main"),
    (f"n=1 [1,{H_WINDOW},{H_WIDTH}]", (1, H_WINDOW, H_WIDTH), 0, True, "n1"),
    ("ragged [3,37,2560]", (3, 37, H_WIDTH), 0, False, None),
    ("tail [2,300,2560], last 87 identity", (2, 300, H_WIDTH), 87, False,
     None),
    ("rows route [2,37,1001]", (2, 37, 1001), 0, False, None)]


def check_rglru(dev, gen) -> dict:
    """``rglru_scan`` on RG_CASES: bit-equal to its plain version and on
    two calls, its launch plan printed; an identity tail leaves h at its
    last real step's value; timed in fp32, the path's carry dtype, eager
    and as device time (CUDA graph)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import sm_count
    from repro_torch.kernels.rglru_scan import plan

    entries = {}
    for label, (b, s, w), tail, timed, entry in RG_CASES:
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            a = torch.rand(b, s, w, generator=gen, device=dev).to(dt)
            bx = torch.randn(b, s, w, generator=gen, device=dev).to(dt)
            if tail:
                a[:, s - tail:], bx[:, s - tail:] = 1.0, 0.0
            h0 = torch.randn(b, w, generator=gen, device=dev)
            got = ops.lru_scan(a, bx, h0)
            want = ops.lru_scan_ref(a, bx, h0)
            err = compare(f"rglru_scan {label} {dname}", got, want, dname)
            if not torch.equal(got, want):
                raise AssertionError(f"rglru_scan {label} {dname}: not bit-equal "
                                     f"to its plain version")
            bit_stable(f"rglru_scan {label} {dname}", got,
                       ops.lru_scan(a, bx, h0))
            if tail and not torch.equal(
                    got[:, s - tail:],
                    got[:, s - tail - 1:s - tail].expand(b, tail, w)):
                raise AssertionError(f"rglru_scan {label} {dname}: identity "
                                     f"steps moved h")
            p = plan(b, w, a.element_size(), True, sm_count(a.device))
            line = (f"[kernel] rglru_scan {label} {dname}: route {p.kernel} "
                    f"cw {p.cw} grid {p.grid}; max_abs_err {err:.3e} "
                    f"(bit-equal, bit-stable)")
            if timed and dname == "float32":
                ms = time_ms(lambda: ops.lru_scan(a, bx, h0))
                dms = graph_ms(lambda: ops.lru_scan(a, bx, h0))
                plain = time_ms(lambda: ops.lru_scan_ref(a, bx, h0), iters=3,
                                warmup=1)
                nb, kind = bound_ms(3 * b * s * w * 4 + b * w * 4,
                                    2.0 * b * s * w, dname)
                line += (f" ms {ms:.4f} device_ms {dms:.4f} (CUDA graph) "
                         f"plain_ms {plain:.4f} library_ms null (no PyTorch "
                         f"call computes a linear recurrence) bound_ms "
                         f"{nb:.4f} ({kind}) bound/device {nb / dms:.2f}")
                row = dict(shape=f"a,b[{b},{s},{w}] f32, h0[{b},{w}]",
                           variant=f"{p.kernel} cw {p.cw} grid {p.grid}",
                           max_abs_err=err, ms=ms, device_ms=dms,
                           plain_ms=plain, bound_ms=nb, bound_by=kind,
                           library_ms=None, bit_stable=True)
                if entry == "main":
                    entries["rglru_scan"] = row
                else:
                    entries["rglru_scan"][entry] = row
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
     True, False),
    # the other tensor-core instances: 6 of 8 warps owning k-steps (D =
    # 96), 2 and 3 k-steps a warp (D = 256, 384)
    ("tail D=96 [3,50,96], last 20 identity", 3, 50, 96, BOTH, 20, False,
     False),
    ("state D=256 [4,100,256]", 4, 100, 256, BOTH, 0, True, False),
    ("state + tail D=384 [2,40,384], last 7 identity", 2, 40, 384, BOTH, 7,
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
    of MLSTM_CASES: h and the final (C, n, m) against the plain version
    (in bf16 its mirror of the tensor-core kernel, C and w k as three bf16
    terms), two calls bit-equal; with an identity-gate tail, the outputs
    before it and the final state against the kernel on the unpadded
    prefix too."""
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
            want = ops.mlstm_fold_ref(*args, split=dname == "bfloat16")
            errs = [compare(f"mlstm_chunkwise {label} {dname} {part}", g, w, dname)
                    for part, g, w in zip(("h", "C", "n", "m"), got, want)]
            for part, first, second in zip(("h", "C", "n", "m"), got,
                                           ops.mlstm_fold(*args)):
                bit_stable(f"mlstm_chunkwise {label} {dname} {part}", first,
                           second)
            line = (f"[kernel] mlstm_chunkwise {label} {dname}: max_abs_err h "
                    f"{errs[0]:.3e} C {errs[1]:.3e} n {errs[2]:.3e} m {errs[3]:.3e} "
                    f"(bit-stable)")
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
                dms = graph_ms(lambda: ops.mlstm_fold(*args), calls=5)
                plain = time_ms(lambda: ops.mlstm_fold_ref(*args), 3, 1)
                (nb, kind), flops = mlstm_bound(bh, s, d, q.element_size(), dname,
                                                with_state)
                line += (f" ms {ms:.4f} device_ms {dms:.4f} (CUDA graph) plain_ms "
                         f"{plain:.4f} library_ms null (no PyTorch call computes "
                         f"the mLSTM) bound_ms {nb:.4f} ({kind}; {flops:.4e} "
                         f"flops)")
                entries["mlstm_chunkwise"] = dict(
                    shape=f"q,k,v[{bh},{s},{d}] bf16, gates f32, zero state",
                    max_abs_err=errs[0], ms=ms, device_ms=dms, plain_ms=plain,
                    bound_ms=nb, bound_by=kind, library_ms=None,
                    bit_stable=True)
            log(line)
            del q, k, v, got
    return entries


# --------------------------------------------------------------------------
# phase 3-q8: flash_attention's int8 body and its shared-prefix entry
# --------------------------------------------------------------------------

# flash_attention's int8 body (the TPU kernel's own function): (label, BH,
# S, T, D, causal, window, timed); every case with fp32 and bf16 q
FQ8_CASES = [
    (f"BH={7 * Q_HEADS} S=T=256 causal", 7 * Q_HEADS, 256, 256, 64, True, 0,
     True),
    ("ragged BH=6 S=T=100", 6, 100, 100, 64, True, 0, False),
    ("window BH=6 S=T=200 w=48", 6, 200, 200, 64, True, 48, False),
    ("non-causal BH=4 S=50 T=77", 4, 50, 77, 64, False, 0, False),
    ("D=16 BH=3 S=T=70", 3, 70, 70, 16, True, 0, False),
    ("D=32 non-causal BH=2 S=40 T=90 window 20", 2, 40, 90, 32, False, 20,
     False),
    ("D=128 BH=4 S=T=70", 4, 70, 70, 128, True, 0, False),
    ("D=256 BH=4 S=T=77 window 30", 4, 77, 77, 256, True, 30, False),
    ("D=256 non-causal BH=3 S=40 T=50", 3, 40, 50, 256, False, 0, False)]
# its shared-prefix entry: (label, BH, suffix S, D, prefix span, pre_len,
# timed); every case with fp32 and bf16 q and an fp and an int8 prefix.
# The first is the shared prefill of phases 4e/4f: 7 sharers x 16 heads,
# a suffix bucket of 64, the 200-token system prompt gathered as 4 pages
PREFIX_CASES = [
    (f"BH={7 * Q_HEADS} S=64 span {4 * PAGE} pre_len {SYS_LEN}", 7 * Q_HEADS,
     64, 64, 4 * PAGE, SYS_LEN, True),
    ("pre_len on a tile edge BH=6 S=40 span 128 pre_len 64", 6, 40, 64, 128,
     64, False),
    ("span = pre_len BH=4 S=33 span 96", 4, 33, 64, 96, 96, False),
    ("pre_len 1 BH=3 S=9 span 64", 3, 9, 64, 64, 1, False),
    ("D=32 BH=3 S=30 span 100 pre_len 70", 3, 30, 32, 100, 70, False),
    ("D=128 BH=4 S=50 span 100 pre_len 77", 4, 50, 128, 100, 77, False),
    ("D=256 BH=4 S=50 span 64 pre_len 40", 4, 50, 256, 64, 40, False),
    ("D=256 BH=3 S=17 span 48 pre_len 32 (tile edge)", 3, 17, 256, 48, 32,
     False)]


def ptxas_kernels(out: str) -> dict:
    """Registers and (spill stores, spill loads) bytes of every kernel in
    one source's ``ptxas -v`` output, keyed by its mangled name."""
    import re
    info, entry = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            info[entry] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            info[entry]["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            info[entry]["registers"] = int(m.group(1))
    return info


def flash_instance(dt, d: int, prefix_q8: bool = False,
                   main_q8: bool = False):
    """(readable name, mangled-name fragment) of the flash_attention.cu
    kernel that a call with q in ``dt`` and head dim ``d`` launches
    (``flash_attention.kernel_for``): ``flash_tc_kernel<D>``,
    ``flash_terms_kernel<T, PK, K, D>`` or
    ``flash_split_kernel<T, PK, K, D, D / 32>``, template arguments as the
    Itanium ABI writes them (float ``f``, int8_t ``a``, __nv_bfloat16 once
    in full, then ``S1_``)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel_for
    kern = kernel_for(dt, d, prefix_q8, main_q8)
    if kern == "flash_tc_kernel":
        return f"flash_tc_kernel<{d}>", f"flash_tc_kernelILi{d}EE"
    bf = dt == torch.bfloat16
    names = ("__nv_bfloat16" if bf else "float", "signed char")
    codes = ("13__nv_bfloat16" if bf else "f", "S1_" if bf else "f", "a")
    targs = [names[0], names[prefix_q8], names[main_q8]]
    tail, extra = {"flash_terms_kernel": (f"Li{d}EE", f", {d}"),
                   "flash_split_kernel": (f"Li{d}ELi{d // 32}EE",
                                          f", {d}, {d // 32}")}[kern]
    mangled = (f"{kern}I{codes[0]}{codes[2] if prefix_q8 else codes[1]}"
               f"{codes[2] if main_q8 else codes[1]}{tail}")
    return f"{kern}<{', '.join(targs)}{extra}>", mangled


def ptxas_note(table: dict, instance) -> str:
    readable, mangled = instance
    hits = [v for name, v in table.items() if mangled in name]
    if not hits:
        return f"ptxas {readable}: not in this process's build log"
    v = hits[0]
    st, ld = v.get("spills", ("?", "?"))
    return (f"ptxas {readable}: {v.get('registers', '?')} registers, spill "
            f"stores {st} B, loads {ld} B")


def check_flash_q8(dev, gen, entries: dict) -> None:
    """Phase 3-q8: the int8 body of ``flash_attention`` on FQ8_CASES and
    its shared-prefix entry, fp and int8 prefix, on PREFIX_CASES, each in
    fp32 and bf16 q, against their plain versions. Prefix rows at or past
    ``pre_len`` hold large garbage (1e4, or int8 scaled by 1e3): they must
    be masked, not read. Timed: the int8 body and the int8 prefix with
    fp32 q (the INT8 path's activations), the fp prefix in bf16 (phase
    4e's); yardstick: dequantise (+ cat) ahead of time, then SDPA with a
    boolean mask, two calls (no PyTorch call dequantises inside
    attention); no library call. Fills ``entries["flash_attention_q8"]``
    (the int8 prefix; the int8 body as its sub-entry ``own``) and
    ``entries["flash_attention"]["prefix"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch import quant as Q
    from repro_torch.kernels import build, ops

    table = ptxas_kernels(build.build_log.get("flash_attention", ""))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    entries.setdefault("flash_attention_q8", {})

    def randn(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    for label, bh, s, t, d, causal, window, timed in FQ8_CASES:
        k8, v8 = (Q.quantize_kv(randn(bh, t, 1, d)) for _ in range(2))
        k, v = k8.q[:, :, 0], v8.q[:, :, 0]
        ks, vs = k8.scale[:, :, 0], v8.scale[:, :, 0]
        for dname, dt in dtypes.items():
            q = randn(bh, s, d, dt=dt)
            kw = dict(k_scale=ks, v_scale=vs, causal=causal, window=window)
            got = ops.attention(q, k, v, **kw)
            want = ops.attention_ref(q, k, v, **kw)
            err = compare(f"flash_attention_q8 {label} {dname}", got, want, dname)
            bit_stable(f"flash_attention_q8 {label} {dname}", got,
                       ops.attention(q, k, v, **kw))
            line = (f"[kernel] flash_attention_q8 {label} {dname}: max_abs_err "
                    f"{err:.3e}; {ptxas_note(table, flash_instance(dt, d, main_q8=True))}")
            if timed and dname == "float32":
                pairs = bh * s * (s + 1) // 2
                pos = torch.arange(s, device=dev)
                mask = pos[None, :] <= pos[:, None]

                def yard():
                    kd = (k.float() * ks).to(dt)[None]
                    vd = (v.float() * vs).to(dt)[None]
                    return F.scaled_dot_product_attention(q[None], kd, vd,
                                                          attn_mask=mask)

                ms = time_ms(lambda: ops.attention(q, k, v, **kw))
                plain = time_ms(lambda: ops.attention_ref(q, k, v, **kw))
                yd = time_ms(yard)
                dms, yms = graph_ms(lambda: ops.attention(q, k, v, **kw)), \
                    graph_ms(yard)
                nb, kind = flash_bound(
                    2 * bh * s * d * 4 + 2 * bh * t * (d + 4),
                    [(4.0 * d * pairs, dname, "int8")], dt, d, main_q8=True)
                line += (f" ms {ms:.4f} plain_ms {plain:.4f} yardstick_ms "
                         f"{yd:.4f} (dequantise, then SDPA with a boolean "
                         f"mask: two calls) bound_ms {nb:.4f} ({kind}); "
                         f"device_ms {dms:.4f} yardstick_device_ms {yms:.4f} "
                         f"(CUDA graph)")
                entries["flash_attention_q8"]["own"] = dict(
                    shape=f"q[{bh},{s},{d}] fp32, int8 k,v[{bh},{t},{d}] + "
                          f"f32 scales, causal",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=nb,
                    bound_by=kind, library_ms=None, yardstick_ms=yd,
                    device_ms=dms, yardstick_device_ms=yms)
            log(line)

    for label, bh, s, d, span, pre_len, timed in PREFIX_CASES:
        k, v = randn(bh, s, d), randn(bh, s, d)
        pk, pv = randn(bh, span, d), randn(bh, span, d)
        pk[:, pre_len:], pv[:, pre_len:] = 1e4, -1e4  # garbage past pre_len
        k8, v8 = Q.quantize_kv(pk[:, :, None]), Q.quantize_kv(pv[:, :, None])
        k8.scale[:, pre_len:], v8.scale[:, pre_len:] = 1e3, 1e3
        int8 = dict(pre_k_scale=k8.scale[:, :, 0], pre_v_scale=v8.scale[:, :, 0])
        for dname, dt in dtypes.items():
            q = randn(bh, s, d, dt=dt)
            kt, vt = k.to(dt), v.to(dt)
            for pname, pre, scales in (
                    ("fp", (pk.to(dt), pv.to(dt)), {}),
                    ("int8", (k8.q[:, :, 0], v8.q[:, :, 0]), int8)):
                args = (q, *pre, pre_len, kt, vt)
                got = ops.prefix_attention(*args, **scales)
                want = ops.prefix_attention_ref(*args, **scales)
                name = "flash_attention_q8" if scales else "flash_attention"
                err = compare(f"{name} prefix {pname} {label} {dname}", got,
                              want, dname)
                bit_stable(f"{name} prefix {pname} {label} {dname}", got,
                           ops.prefix_attention(*args, **scales))
                inst = flash_instance(dt, d, prefix_q8=bool(scales))
                line = (f"[kernel] {name} prefix ({pname} prefix) {label} "
                        f"{dname}: max_abs_err {err:.3e}; "
                        f"{ptxas_note(table, inst)}")
                if timed and (dname == "float32") == bool(scales):
                    mask = torch.cat([
                        (torch.arange(span, device=dev) < pre_len)[None]
                        .expand(s, span),
                        torch.ones(s, s, dtype=torch.bool, device=dev).tril()],
                        dim=1)

                    def yard():
                        if scales:
                            kd = (pre[0].float() * scales["pre_k_scale"]).to(dt)
                            vd = (pre[1].float() * scales["pre_v_scale"]).to(dt)
                        else:
                            kd, vd = pre
                        kc = torch.cat([kd, kt], 1)[None]
                        vc = torch.cat([vd, vt], 1)[None]
                        return F.scaled_dot_product_attention(
                            q[None], kc, vc, attn_mask=mask)

                    ms = time_ms(lambda: ops.prefix_attention(*args, **scales))
                    plain = time_ms(lambda: ops.prefix_attention_ref(*args,
                                                                     **scales))
                    yd = time_ms(yard)
                    esz = q.element_size()
                    pre_bytes = (2 * bh * pre_len * (d + 4) if scales
                                 else 2 * bh * pre_len * d * esz)
                    parts = [(4.0 * d * bh * s * pre_len, dname,
                              "int8" if scales else dname),
                             (4.0 * d * bh * s * (s + 1) // 2, dname, dname)]
                    nb, kind = flash_bound(4 * bh * s * d * esz + pre_bytes,
                                           parts, dt, d, bool(scales))
                    dms, yms = graph_ms(lambda: ops.prefix_attention(
                        *args, **scales)), graph_ms(yard)
                    line += (f" ms {ms:.4f} plain_ms {plain:.4f} yardstick_ms "
                             f"{yd:.4f} ({'dequantise + ' if scales else ''}"
                             f"cat, then SDPA with a boolean mask: two calls) "
                             f"bound_ms {nb:.4f} ({kind}); device_ms {dms:.4f} "
                             f"yardstick_device_ms {yms:.4f} (CUDA graph)")
                    row = dict(
                        shape=f"q,k,v[{bh},{s},{d}] {dname}, {pname} prefix "
                              f"[{bh},{span},{d}] pre_len {pre_len}",
                        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=nb,
                        bound_by=kind, library_ms=None, yardstick_ms=yd,
                        device_ms=dms, yardstick_device_ms=yms,
                        yardstick=("dequantise + cat, then SDPA with a "
                                   "boolean mask (two calls)" if scales else
                                   "cat, then SDPA with a boolean mask "
                                   "(two calls)"))
                    if scales:
                        entries["flash_attention_q8"].update(row)
                    else:
                        entries["flash_attention"]["prefix"] = row
                log(line)


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
    stats = dict(engine.step_stats(),
                 peak_allocated_bytes=torch.cuda.max_memory_allocated())
    del engine, model
    torch.cuda.empty_cache()
    return counts, {r.rid: list(r.out_tokens) for r in done}, stats


# --------------------------------------------------------------------------
# phases 4j, 4k: deepseek-moe-16b and the head-dim-128 dense configs
# --------------------------------------------------------------------------

def pass_launches(model) -> dict:
    """The launches of one pass of ``model`` (a decode step or a prefill
    group) from its config: per attention layer 4 projections and its
    MLP (3 matmuls gated, 2 relu2; in an MoE layer the router and the
    shared experts' MLP, and 3 or 2 expert products), one unembedding;
    one attention per layer, in the step (``paged_attention``) or the
    group (``flash_attention``)."""
    arch = model.arch
    mlp = 2 if arch.mlp == "relu2" else 3
    n_moe = sum(layer.is_moe for layer in model.layers)
    shared = mlp if arch.num_shared_experts else 0
    return {"xfer_matmul": (4 + mlp) * (len(model.layers) - n_moe)
            + (4 + 1 + shared) * n_moe + 1,
            "xfer_matmul_experts": mlp * n_moe, "attention": len(model.layers)}


def serve_d128(tag: str, arch, model=None, paged: bool = False):
    """Phases 4j and 4k: phase 4's 16 prompts (16-200 tokens, 32 new
    tokens each) through ``arch`` at full width in bf16 on 8 slots x 512
    (pages of 64 when ``paged``: the MoE family keeps no prefix
    registry), seeded weights (``model``, or made here). Launch counts
    exact per decode step and per prefill group (``pass_launches``),
    every request to its budget; prints step p50/p95, admission p50,
    tokens/s, peak allocated bytes and the step's byte bound (every
    weight but the embedding table, read once a step: at 8 slots the MoE
    layers' capacity is 1 and every expert runs). Returns (launch
    counts, streams, model)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import PagingConfig, ServeConfig, ServingEngine

    new_tokens = 32
    config = ServeConfig(slots=SLOTS, max_len=MAX_LEN, seed=0, lookahead=1,
                         paging=PagingConfig(paged=paged, page_size=PAGE))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if model is None:
        model = init_params(arch, config.seed)  # on the card, bf16
    engine = ServingEngine(arch, model, config=config)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    step_bytes = weight_bytes - model.embed.numel() * model.embed.element_size()
    per = pass_launches(model)
    log(f"[{tag}] {arch.name}: {arch.num_layers} layers (MoE "
        f"{sum(layer.is_moe for layer in model.layers)}), d {arch.d_model}, "
        f"heads {arch.num_heads}/{arch.num_kv_heads} x {arch.head_dim}, mlp "
        f"{arch.mlp}, {n_params} params ({weight_bytes} bytes), "
        f"{'pool of pages of %d' % PAGE if paged else 'slot grid'}; params + "
        f"engine + capture ready in {time.perf_counter() - t0:.1f} s; per "
        f"pass {per}")
    prompts = phase4_prompts(arch.vocab_size)
    ops.reset_launches()
    t0 = time.perf_counter()
    streams, steps, groups, _, peak_pages = drive(engine, prompts, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rid, toks in streams.items():
        if len(toks) != new_tokens or not all(0 <= t < arch.vocab_size
                                               for t in toks):
            raise AssertionError(f"[{tag}] rid {rid}: bad stream {toks}")
    path = PATH_KERNELS["moe" if arch.family == "moe" else "dense-d128"]
    want = {"xfer_matmul": per["xfer_matmul"] * (steps + groups),
            "xfer_matmul_experts": per["xfer_matmul_experts"] * (steps + groups),
            "paged_attention": per["attention"] * steps,
            "flash_attention": per["attention"] * groups}
    check_paged_counts(tag, counts, path, want)
    pstats, sstats = engine.prefill_stats(), engine.step_stats()
    if paged and (engine.scheduler.registry is not None
                  or pstats["prefix_hit_rate"] != 0):
        raise AssertionError(f"[{tag}] the MoE pool keeps a prefix registry")
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[{tag}] {len(streams)}/{len(prompts)} requests to their budget, "
        f"{steps} decode steps, {groups} prefill groups, {wall:.3f} s wall; "
        f"launches {counts} (exact)" + (f"; peak pages in use {peak_pages}"
                                        if paged else ""))
    log(f"[{tag}] step_p50_ms {sstats['step_p50_ms']:.4f} step_p95_ms "
        f"{sstats['step_p95_ms']:.4f} admit_p50_ms {pstats['admit_p50_ms']:.4f} "
        f"tokens_per_s {sstats['tokens_per_s']:.1f} peak_allocated_bytes "
        f"{torch.cuda.max_memory_allocated()} step_bound_ms {bound:.4f} "
        f"(bytes: {step_bytes} weight bytes a step)")
    log(f"[{tag}] step_stats {json.dumps(sstats)}")
    log(f"[{tag}] prefill_stats {json.dumps(pstats)}")
    log(f"[{tag}] rid=0 out={streams[0][:8]}")
    del engine
    torch.cuda.empty_cache()
    return counts, streams, model


def serve_moe() -> dict:
    """Phase 4j: deepseek-moe-16b at full width and depth (one dense
    layer, 27 MoE layers of 64 experts, top 6, 2 shared) on the slot
    grid, then on the page pool on the same weights; the pool's streams
    held to the grid's (the paged kernel's split differs from the
    grid's, so only a near-tie under the bf16 tolerance may part them).
    Returns the launch counts per path."""
    import torch
    from repro_torch.configs import get_arch

    arch = get_arch("deepseek-moe-16b")
    grid, streams, model = serve_d128("serve-moe", arch)
    pool, pool_streams, model = serve_d128("serve-moe-paged", arch, model,
                                           paged=True)
    compare_streams("serve-moe-paged", model, phase4_prompts(arch.vocab_size),
                    pool_streams, streams, "the grid's")
    del model
    torch.cuda.empty_cache()
    return {"moe": grid, "moe-paged": pool}


#: phase 4k: (arch id, layers or None for full depth)
D128_DENSE = (("minitron-8b", None), ("yi-9b", 8), ("phi3-medium-14b", 8))


def serve_dense_d128() -> dict:
    """Phase 4k: minitron-8b (relu2) at full width and depth, yi-9b and
    phi3-medium-14b at full width with the depth cut to 8 layers (every
    kernel instance is the same at any depth), one model at a time on
    the grid. Returns the launch counts summed over the three."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch

    total = {}
    for arch_id, layers in D128_DENSE:
        arch = get_arch(arch_id)
        if layers:
            arch = dataclasses.replace(arch, num_layers=layers)
        counts, _, model = serve_d128(f"serve-{arch_id}", arch)
        del model
        torch.cuda.empty_cache()
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return total


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
# phase 4g: the captured decode step against the eager one, and a trace
# --------------------------------------------------------------------------

GRAPH_STEPS, TRACE_STEPS = 16, 20
# the serving paths at full width: (tag, arch id, slots, max_len, int8,
# page size or None, mode: None (greedy), "top_k" (k 50, T 0.8) or "spec"
# (phase 4h's 1-layer draft, k = SPEC_K)); 8 prompts of 16-120 tokens
# each, 64 new tokens (128 on the spec paths, so that no slot finishes
# within the 16 steps)
GRAPH_PATHS = (("fp", "qwen1.5-0.5b", SLOTS, MAX_LEN, False, None, None),
               ("int8", "qwen1.5-0.5b", SLOTS, MAX_LEN, True, None, None),
               ("paged", "qwen1.5-0.5b", SLOTS, MAX_LEN, False, PAGE, None),
               ("paged-int8", "qwen1.5-0.5b", SLOTS, MAX_LEN, True, PAGE,
                None),
               ("hybrid", "recurrentgemma-2b", H_SLOTS, H_MAX_LEN, False, None,
                None),
               ("ssm", "xlstm-350m", X_SLOTS, X_MAX_LEN, False, None, None),
               ("top-k", "qwen1.5-0.5b", SLOTS, MAX_LEN, False, None, "top_k"),
               ("spec", "qwen1.5-0.5b", SLOTS, MAX_LEN, False, None, "spec"),
               ("spec-paged", "qwen1.5-0.5b", SLOTS, MAX_LEN, False, PAGE,
                "spec"),
               ("moe", "deepseek-moe-16b", SLOTS, MAX_LEN, False, None, None),
               ("moe-paged", "deepseek-moe-16b", SLOTS, MAX_LEN, False, PAGE,
                None),
               ("relu2", "minitron-8b", SLOTS, MAX_LEN, False, None, None))


def graph_engine(models: dict, arch_id: str, slots: int, max_len: int,
                 int8: bool, page, mode=None, lookahead: int = 1,
                 new_tokens: int = 64):
    """A full-width engine of one serving path (seeded weights, shared
    by the fp paths of one model; an INT8 engine quantises its own; a
    spec engine takes the 1-layer draft) with ``slots`` seeded prompts of
    16-120 tokens submitted."""
    import dataclasses

    import numpy as np
    from repro_torch import quant as Q
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                     ServeConfig, ServingEngine, SpecConfig)
    arch = get_arch(arch_id)
    key = (arch_id, int8 and page)
    if key not in models:
        models[key] = init_params(arch, 0)
    params, extra = models[key], {}
    if mode == "top_k":
        extra["sampling"] = SamplingParams("top_k", 0.8, 50)
    if mode == "spec":
        draft = dataclasses.replace(arch, num_layers=1)
        if "draft" not in models:
            models["draft"] = init_params(draft, 1)
        params = {"target": params, "draft": models["draft"]}
        extra["spec"] = SpecConfig(draft=draft, k=SPEC_K)
        new_tokens = 2 * new_tokens
    config = ServeConfig(slots=slots, max_len=max_len, seed=0,
                         lookahead=lookahead,
                         quant=Q.INT8_SERVE if int8 else Q.QuantConfig(),
                         paging=PagingConfig(paged=page is not None,
                                             page_size=page), **extra)
    engine = ServingEngine(arch, params, config=config)
    rng = np.random.RandomState(7)
    for rid in range(slots):
        engine.submit(Request(rid=rid, prompt=rng.randint(
            1, arch.vocab_size, size=int(rng.randint(16, 121))).astype(np.int32),
            max_new_tokens=new_tokens))
    return engine


def leaf_bytes(engine) -> int:
    from repro_torch.serving.state import tensors
    leaves = [t for c in engine.caches for t in c.values()]
    leaves += list(tensors(engine.state).values())
    return sum(t.numel() * t.element_size() for t in leaves)


def graph_vs_eager() -> dict:
    """Phase 4g, first half: on each path of GRAPH_PATHS, after one
    admission, caches and state are cloned; GRAPH_STEPS eager steps of
    ``registry.build_serve_step`` run on the clone and as many replays of
    the engine's captured step on the originals. Records must be equal
    step by step, caches and state (the sampling keys and the spec
    paths' draft grid included) bit-equal at the end, and each replay's
    launch counts those of its capture. Returns per path the capture's
    launches per replay."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_serve_step
    from repro_torch.serving import state as ST
    from repro_torch.serving.captured import pack_record

    models, per_replay = {}, {}
    for i, (tag, arch_id, slots, max_len, int8, page, mode) in \
            enumerate(GRAPH_PATHS):
        # free the weights no later path reads, so that deepseek's 33 GB
        # and minitron's 15 GB are never resident beside the others
        later = GRAPH_PATHS[i:]
        for key in [k for k in models if k != "draft" and
                    k[0] not in {p[1] for p in later}]:
            del models[key]
        if "draft" in models and not any(p[6] == "spec" for p in later):
            del models["draft"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        engine = graph_engine(models, arch_id, slots, max_len, int8, page,
                              mode)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        a1, r1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        step = engine.decode
        if step.graph is None:
            raise AssertionError(f"[graph-{tag}] no CUDA graph captured")
        engine.scheduler.admit(engine.model, engine.caches, engine.state)
        caches = [{k: v.clone() for k, v in c.items()} for c in engine.caches]
        state = ST.clone(engine.state)
        eager = build_serve_step(engine.arch, sampling=engine.sampling,
                                 eos_id=engine.eos_id, paged=engine.paged,
                                 spec=engine.spec)
        want = []
        for _ in range(GRAPH_STEPS):
            state, caches, rec = eager(engine.params, caches, state)
            want.append(pack_record(rec))
        ops.reset_launches()
        got = [step().clone() for _ in range(GRAPH_STEPS)]
        counts = ops.launch_counts()
        torch.cuda.synchronize()
        expect = {k: GRAPH_STEPS * step.launches.get(k, 0) for k in counts}
        if counts != expect or not step.launches:
            raise AssertionError(f"[graph-{tag}] {GRAPH_STEPS} replays counted "
                                 f"{counts}, the capture {step.launches}")
        bad = [j for j, (g, w) in enumerate(zip(got, want))
               if not torch.equal(g, w)]
        if bad:
            raise AssertionError(f"[graph-{tag}] records differ from the eager "
                                 f"step's at steps {bad}")
        pairs = [(f"caches[{i}].{k}", c[k], engine.caches[i][k])
                 for i, c in enumerate(caches) for k in c]
        live = ST.tensors(engine.state)
        pairs += [(f"state.{k}", v, live[k])
                  for k, v in ST.tensors(state).items()]
        off = {name: float((a.float() - b.float()).abs().max())
               for name, a, b in pairs if not torch.equal(a, b)}
        if off:
            raise AssertionError(f"[graph-{tag}] leaves not bit-equal to the "
                                 f"eager step's (max abs err): {off}")
        emitted = int(state.emitted.sum())
        if mode == "spec":
            emitted = f"{emitted}, accepted {int(state.accepted.sum())} of " \
                      f"{int(state.proposed.sum())} proposed"
        log(f"[graph-{tag}] engine with its capture built in {built:.1f} s "
            f"(caches + state {leaf_bytes(engine)} bytes; allocated "
            f"{a1 - a0:+d}, reserved {r1 - r0:+d} bytes); {GRAPH_STEPS} replays "
            f"= {GRAPH_STEPS} eager steps: records equal ({emitted} tokens), "
            f"{len(pairs)} leaves bit-equal; launches per replay "
            f"{step.launches}; workspaces held {len(step.workspaces)}")
        per_replay[tag] = dict(step.launches)
        del engine, caches, state, step, got, want
    del models
    torch.cuda.empty_cache()
    return per_replay


def trace_window(run, steps: int) -> dict:
    """``run()`` (``steps`` decode steps ending in a synchronize) under
    ``torch.profiler``: the device's busy time (union of kernel, memcpy
    and memset intervals) over the window, device launches per step and
    the top device ops by total time."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("decode_window"):
            run()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == "decode_window"
              and e.get("ph") == "X"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset")]
    if not window or not dev:
        return {"measured": False}
    t0 = float(window[0]["ts"])
    t1 = max(t0 + float(window[0]["dur"]),
             max(float(e["ts"]) + float(e["dur"]) for e in dev))
    busy, end = 0.0, t0
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        a, b = max(float(e["ts"]), end), float(e["ts"]) + float(e["dur"])
        if b > a:
            busy += b - a
            end = b
    by_name = {}
    for e in dev:
        n = e["name"]
        by_name[n] = by_name.get(n, 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kernels = sum(1 for e in dev if e["cat"] == "kernel")
    return {"measured": True, "window_ms": (t1 - t0) / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (t1 - t0),
            "device_ms_per_step": busy / 1e3 / steps,
            "kernels_per_step": kernels / steps,
            "copies_per_step": (len(dev) - kernels) / steps,
            "top": [(n[:60], round(t / 1e3 / steps, 4)) for n, t in top]}


def trace_steps() -> dict:
    """Phase 4g, second half: TRACE_STEPS steady decode steps of
    full-width qwen1.5-0.5b in bf16 (8 slots active, no admission)
    through ``ServingEngine.step()``, traced with ``torch.profiler``:
    first replaying the captured step, then the same engine dispatching
    the eager step; then a speculative engine (phase 4h's 1-layer draft,
    k = SPEC_K) replaying its captured step; then full-size
    deepseek-moe-16b's captured step (phase 4j's model). Prints the
    device's idle share of each window, the top device ops and the
    launches per step that are not the hand-written kernels'."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_serve_step
    from repro_torch.serving.captured import pack_record

    engine = graph_engine({}, "qwen1.5-0.5b", SLOTS, MAX_LEN, False, None,
                          new_tokens=8 * TRACE_STEPS)
    for _ in range(4):  # admission, then steady steps
        engine.step()
    eager = build_serve_step(engine.arch, sampling=engine.sampling,
                             eos_id=engine.eos_id, paged=engine.paged)

    def eager_decode():
        return pack_record(eager(engine.model, engine.caches, engine.state)[2])

    def run():
        for _ in range(TRACE_STEPS):
            engine.step()
        torch.cuda.synchronize()

    out = {}
    for mode in ("graph", "eager", "spec", "moe"):
        if mode == "eager":
            engine.decode = eager_decode
        if mode in ("spec", "moe"):  # spec: budgets of 380 for 64 steps
            del engine               # of up to k + 1
            torch.cuda.empty_cache()
            if mode == "spec":
                engine = graph_engine({}, "qwen1.5-0.5b", SLOTS, MAX_LEN,
                                      False, None, mode="spec",
                                      new_tokens=190)
            else:
                engine = graph_engine({}, "deepseek-moe-16b", SLOTS, MAX_LEN,
                                      False, None, new_tokens=8 * TRACE_STEPS)
            for _ in range(4):
                engine.step()
        run()  # warm
        ops.reset_launches()
        t0 = time.perf_counter()
        run()
        host_ms = (time.perf_counter() - t0) * 1e3 / TRACE_STEPS
        ours = sum(ops.launch_counts().values()) / TRACE_STEPS
        row = trace_window(run, TRACE_STEPS)
        row.update(host_ms_per_step=host_ms, handwritten_per_step=ours)
        if row["measured"]:
            row["other_launches_per_step"] = row["kernels_per_step"] - ours
            log(f"[trace-{mode}] {TRACE_STEPS} steady {engine.arch.name} "
                f"bf16 steps"
                + (f" (k = {SPEC_K}, 1-layer draft)" if mode == "spec" else "")
                + ": "
                f"host {host_ms:.3f} ms a step untraced; traced window "
                f"{row['window_ms']:.3f} ms, device busy {row['busy_ms']:.3f} ms,"
                f" idle share {row['idle_share']:.4f}; a step: device "
                f"{row['device_ms_per_step']:.4f} ms, {row['kernels_per_step']:.1f}"
                f" kernels of which {ours:.1f} hand-written and "
                f"{row['other_launches_per_step']:.1f} not, "
                f"{row['copies_per_step']:.1f} copies/memsets")
            log(f"[trace-{mode}] top device ops (ms a step): {row['top']}")
        else:
            log(f"[trace-{mode}] host {host_ms:.3f} ms a step; idle share not "
                f"measured: the trace holds no device events")
        out[mode] = row
    log(f"[trace] {json.dumps(out)}")
    del engine
    torch.cuda.empty_cache()
    return out


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
                     kv_quant: bool, note=None) -> None:
    """A batched bucketed prefill of 4 prompts and 4 greedy decode steps
    on the card and on the CPU, fed the same tokens (the CPU's greedy
    choices); last-position logits within PARITY_TOL of max |logit|.
    ``note(j)``, when given, adds a remark on position j to its line and
    to a failure's message."""
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
        if note is not None:
            line += f"; {note(j)}"
        for b in flips:
            top = torch.topk(w[b], 2).values
            margin = float(top[0] - top[1]) / scale
            line += f"; row {b} flips with top-2 margin {margin:.3e}"
            if margin > PARITY_TOL:
                raise AssertionError(f"greedy token differs at position {j} row "
                                     f"{b} with margin {margin:.3e} > "
                                     f"{PARITY_TOL} ({line})")
        log(line)
        if rel > PARITY_TOL:
            raise AssertionError(f"card vs CPU logits: rel err {rel:.3e} > "
                                 f"{PARITY_TOL} ({line})")
    log(f"[{tag}] ok: worst rel err {worst:.3e} (tolerance {PARITY_TOL})")


#: phase 5g: (arch id, layers): deepseek-moe-16b cut to its dense prefix
#: layer and 2 MoE layers, at its own capacity factor 1.25 (assignments
#: drop), and minitron-8b (relu2) cut to 2 layers, both at full width
PARITY_D128 = (("deepseek-moe-16b", 3), ("minitron-8b", 2))


def parity_moe(dev) -> None:
    """Phase 5g: seeded fp32 weights (drawn on the card, copied to the
    CPU), compare_card_cpu's prefill of 4 prompts in a 64 bucket and 4
    greedy decode steps, card vs CPU: logits within PARITY_TOL, greedy
    tokens equal (a flip only under a top-2 margin of PARITY_TOL). Each
    position's line carries the smallest router margin of the CPU's
    forward there (the k-th against the (k+1)-th probability over every
    token and MoE layer): a routing flip between the two sides can only
    come from a margin of the order of fp32's rounding."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import LM
    from repro_torch.models.registry import init_params

    for arch_id, layers in PARITY_D128:
        arch = dataclasses.replace(get_arch(arch_id), num_layers=layers)
        tag = f"parity-{arch_id}"
        t0 = time.perf_counter()
        card_model = init_params(arch, 1, dtype=torch.float32)
        cpu_model = LM(arch, device=torch.device("cpu"), dtype=torch.float32)
        cpu_model.load_state_dict(card_model.state_dict())
        n_moe = sum(layer.is_moe for layer in card_model.layers)
        log(f"[{tag}] {layers} layers ({n_moe} MoE, capacity factor "
            f"{arch.moe_capacity_factor}), d {arch.d_model}, mlp {arch.mlp}: "
            f"fp32 weights on card and CPU in {time.perf_counter() - t0:.1f} s")

        with router_margins() as margins:
            def note(j):
                if not n_moe:
                    return "no router"
                cpu = [m for d, m in margins
                       if d == "cpu"][j * n_moe:(j + 1) * n_moe]
                return f"smallest router margin (CPU) {min(cpu):.3e}"

            compare_card_cpu(arch, cpu_model, card_model, tag, kv_quant=False,
                             note=note)
        del card_model, cpu_model
        torch.cuda.empty_cache()


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
        # clones: on the CPU .float().cpu() is the live leaf, which the
        # decode steps below update in place
        hs = [[grid[i]["h"].float().cpu().clone() for i in rec]]
        chosen = [out[-1].argmax(-1).to(torch.int32)]
        pos = torch.from_numpy(lens).to(d)[:, None]
        for j in range(steps):
            tok = (feed[j] if feed is not None else chosen[-1]).to(d)[:, None]
            hidden, grid = model(tok, caches=grid, positions=pos)
            out.append(model.logits(hidden)[:, -1].float().cpu())
            hs.append([grid[i]["h"].float().cpu().clone() for i in rec])
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

    def states(grid):  # copies: decode updates the live leaves in place
        out = {f"{i}.{k}": v.float().cpu().clone() for i, c in enumerate(grid)
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


# --------------------------------------------------------------------------
# phases 4e, 4f: the paged pool with prefix reuse
# --------------------------------------------------------------------------

def shared_set(vocab: int):
    """The shared traffic set: the 200-token system prompt alone (the
    owner, rid 0: its whole prompt is registered, so the others match it
    8 tokens into its fourth page and copy that page on write) and 15
    prompts of the system prompt plus a distinct tail of 8-120 tokens."""
    import numpy as np
    rng = np.random.RandomState(3)
    sys_prompt = rng.randint(1, vocab, size=SYS_LEN).astype(np.int32)
    prompts = [sys_prompt]
    for _ in range(N_SHARERS):
        tail = rng.randint(1, vocab, size=int(rng.randint(
            TAIL_RANGE[0], TAIL_RANGE[1] + 1))).astype(np.int32)
        prompts.append(np.concatenate([sys_prompt, tail]))
    return prompts


@contextlib.contextmanager
def router_margins():
    """Within the block, every MoE routing (``moe.route``) appends (its
    tokens' device type, its smallest router margin: the k-th against
    the (k+1)-th probability over its tokens) to the list it yields."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    route, margins = M.route, []

    def recording_route(arch, hf, router):
        gates, idx = route(arch, hf, router)
        probs = torch.softmax(L.dense(hf, router).float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = top[:, arch.top_k - 1] - top[:, arch.top_k]
        margins.append((hf.device.type, float(gap.min())))
        return gates, idx

    M.route = recording_route
    try:
        yield margins
    finally:
        M.route = route


def top2_margin(model, prompt, prefix) -> float:
    """Top-2 logit margin over max |logit| of ``model`` after ``prompt``
    + ``prefix`` (one full causal forward, no cache)."""
    import numpy as np
    import torch
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(toks).to(model.device)[None])
        lg = model.logits(hidden[:, -1]).float()[0]
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1]) / float(lg.abs().max())


def compare_streams(tag: str, model, prompts, got: dict, want: dict,
                    what: str, limit=TOL["bfloat16"]) -> int:
    """Streams of ``got`` against ``want``; a divergence prints the top-2
    margin where it starts (and, for an MoE model, the smallest router
    margin of that forward) and fails when the top-2 margin is over
    ``limit`` (the bf16 tolerance: a near-tie may flip under rounding;
    None: only print). Returns the count of equal streams."""
    same = 0
    for rid in sorted(want):
        g, w = got[rid], want[rid]
        if g == w:
            same += 1
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        with router_margins() as routed:
            margin = top2_margin(model, prompts[rid], w[:j])
        log(f"[{tag}] rid {rid} diverges from {what} at token {j}: top-2 "
            f"margin {margin:.3e} of max |logit|" + (
                f", smallest router margin {min(m for _, m in routed):.3e}"
                if routed else ""))
        if limit is not None and margin > limit:
            raise AssertionError(f"[{tag}] rid {rid}: stream differs from "
                                 f"{what} at token {j} with margin "
                                 f"{margin:.3e} > {limit}")
    log(f"[{tag}] {same}/{len(want)} streams equal to {what}")
    return same


def drive(engine, prompts, new_tokens: int, owner: bool = False):
    """Submit ``prompts`` (rid = index) and drain. With ``owner``, rid 0
    is admitted by one step before the rest are submitted. Returns
    (streams, decode steps, prefill groups, shared groups, peak pages in
    use; 0 for a dense engine), steps and groups counted over the whole
    drive."""
    from repro_torch.serving import Request
    pool = engine.scheduler.pool
    peak = [0]
    step = engine.step

    def sampled_step():
        step()
        if pool is not None:
            peak[0] = max(peak[0], pool.used_pages)

    engine.step = sampled_step
    steps = groups = shared = 0
    rest = list(enumerate(prompts))
    if owner:
        engine.submit(Request(rid=0, prompt=prompts[0],
                              max_new_tokens=new_tokens))
        engine.step()
        st = engine.prefill_stats()
        steps, groups, shared = 1, int(st["prefill_dispatches"]), \
            int(st["shared_dispatches"])
        rest = rest[1:]
    for rid, p in rest:
        engine.submit(Request(rid=rid, prompt=p, max_new_tokens=new_tokens))
    steps += engine.run_until_drained()
    del engine.step
    st = engine.prefill_stats()
    groups += int(st["prefill_dispatches"])
    shared += int(st["shared_dispatches"])
    done = sorted(engine.completed, key=lambda r: r.rid)
    streams = {r.rid: list(r.out_tokens) for r in done}
    if sorted(streams) != list(range(len(prompts))):
        raise AssertionError(f"{len(streams)}/{len(prompts)} requests completed")
    return streams, steps, groups, shared, peak[0]


def check_paged_counts(tag: str, counts: dict, path: tuple, want: dict) -> None:
    for name, n in counts.items():
        if (n == 0) == (name in path):
            raise AssertionError(f"[{tag}] {name} launched {n} times on a path "
                                 f"that runs {path}")
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"[{tag}] {name} launched {counts[name]} "
                                 f"times, expected {n}")


def serve_paged(dense_streams: dict, int8: bool = False) -> dict:
    """Phase 4e (bf16) or 4f (``INT8_SERVE``, int8 pools): full-width
    qwen1.5-0.5b on 8 slots x 512 through page tables (pages of 64, the
    default pool of 65 pages). 4e serves phase 4's 16 prompts (streams
    against phase 4's dense ones) and then the shared set (against a
    dense engine's); 4f the shared set. Launch counts are exact per
    traffic set; returns their sum."""
    import numpy as np
    import torch
    from repro_torch import quant as Q
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import PagingConfig, ServeConfig, ServingEngine

    tag = "paged-int8" if int8 else "paged"
    arch = get_arch("qwen1.5-0.5b")
    new_tokens, layers = 32, arch.num_layers
    per_pass = 7 * layers + 1
    quant = Q.INT8_SERVE if int8 else Q.QuantConfig()
    config = ServeConfig(slots=SLOTS, max_len=MAX_LEN, seed=0, lookahead=1,
                         paging=PagingConfig(paged=True, page_size=PAGE),
                         quant=quant)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(arch, config.seed)  # phase 4's weights, bf16
    shared = shared_set(arch.vocab_size)
    sets = [("shared", shared, True)]
    if not int8:
        rng = np.random.RandomState(0)  # phase 4's prompts
        phase4 = []
        for _ in range(16):
            s = int(rng.randint(16, 201))
            phase4.append(rng.randint(1, arch.vocab_size, size=s).astype(np.int32))
        sets.insert(0, ("phase-4 prompts", phase4, False))
    total = {}
    for label, prompts, owner in sets:
        # a fresh pool and registry per traffic set (the model is shared;
        # under INT8_SERVE it is quantised by the first engine)
        engine = ServingEngine(arch, model, config=config)
        log(f"[{tag}] {label}: pool of {engine.kv_pages} pages x {PAGE} "
            f"tokens, table {tuple(engine.state.page_table.shape)}, kv dtype "
            f"{engine.caches[0]['kp'].dtype}")
        ops.reset_launches()
        t0 = time.perf_counter()
        streams, steps, groups, n_shared, peak = drive(engine, prompts,
                                                       new_tokens, owner)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for rid, toks in streams.items():
            if len(toks) != new_tokens or not all(0 <= t < arch.vocab_size
                                                   for t in toks):
                raise AssertionError(f"[{tag}] rid {rid}: bad stream {toks}")
        pstats = engine.prefill_stats()
        lm_groups = groups - n_shared
        if int8:
            path = ("quant_matmul", "flash_attention", "flash_attention_q8",
                    "paged_attention_q8")
            want = {"quant_matmul": per_pass * (steps + groups),
                    "flash_attention": layers * lm_groups,
                    "flash_attention_q8": layers * n_shared,
                    "paged_attention_q8": layers * steps}
        else:
            path = ("xfer_matmul", "flash_attention", "paged_attention")
            want = {"xfer_matmul": per_pass * (steps + groups),
                    "flash_attention": layers * groups,
                    "paged_attention": layers * steps}
        check_paged_counts(tag, counts, path, want)
        if owner and not n_shared:
            raise AssertionError(f"[{tag}] no shared-prefix group ran")
        log(f"[{tag}] {label}: {len(streams)} requests, {steps} decode steps, "
            f"{groups} prefill groups ({n_shared} shared), {wall:.3f} s wall; "
            f"prefix_hit_rate {pstats['prefix_hit_rate']:.4f}; peak pages in "
            f"use {peak} of {engine.kv_pages - 1}; launches {counts} (exact)")
        log(f"[{tag}] {label}: step_stats {json.dumps(engine.step_stats())}")
        log(f"[{tag}] {label}: prefill_stats {json.dumps(pstats)}")
        if owner and pstats["prefix_hit_rate"] <= 0:
            raise AssertionError(f"[{tag}] prefix_hit_rate 0 on the shared set")
        if label == "phase-4 prompts":
            compare_streams(tag, model, prompts, streams, dense_streams,
                            "phase 4's dense streams")
        elif not int8:
            dense = ServingEngine(arch, model, config=ServeConfig(
                slots=SLOTS, max_len=MAX_LEN, seed=0, lookahead=1))
            want_streams = drive(dense, prompts, new_tokens, owner)[0]
            del dense
            compare_streams(tag, model, prompts, streams, want_streams,
                            "the dense engine's")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        kv = sum(t.numel() * t.element_size() for c in engine.caches
                 for t in c.values())
        log(f"[{tag}] {label}: pool bytes {kv} weight_bytes "
            f"{Q.leaf_bytes(model)} peak_allocated_bytes "
            f"{torch.cuda.max_memory_allocated()}; pages in use after drain "
            f"{engine.scheduler.pool.used_pages} (registry pins)")
        del engine
    del model
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------------------------------
# phases 4h, 4i: speculative and sampled serving
# --------------------------------------------------------------------------

def phase4_prompts(vocab: int) -> list:
    """Phase 4's 16 prompts (16-200 tokens, seed 0)."""
    import numpy as np
    rng = np.random.RandomState(0)
    out = []
    for _ in range(16):
        s = int(rng.randint(16, 201))
        out.append(rng.randint(1, vocab, size=s).astype(np.int32))
    return out


def spec_launches(layers: int, draft_layers: int, k: int) -> tuple:
    """(per replay, per prefill group) launches of the speculative path:
    a replay runs k + 1 draft forwards (k with the unembedding) and one
    target verify; an admission group prefills the target (or its suffix
    after a shared prefix) and the draft over the full prompts."""
    per_replay = {"xfer_matmul": (k + 1) * 7 * draft_layers + k
                  + 7 * layers + 1,
                  "paged_attention": (k + 1) * draft_layers + layers}
    per_group = {"xfer_matmul": 7 * layers + 1 + 7 * draft_layers + 1,
                 "flash_attention": layers + draft_layers}
    return per_replay, per_group


def serve_spec(dense_streams: dict, dense_stats: dict) -> dict:
    """Phase 4h: full-width qwen1.5-0.5b (24 layers, bf16) served with
    ``ServeConfig(spec=SpecConfig(draft, k=4))``, the draft qwen's widths
    at 1 layer (the reference's pairing), both seeded: phase 4's 16
    prompts on the grid and phase 4e's shared-prefix set on the paged
    pool (pages of 64), 32 new tokens each. Launch counts exact (each
    replay SPEC_K + 1 draft forwards and one verify); every request gets
    its budget. Prints step p50, tokens/s, accepted_tokens_mean,
    draft_acceptance and peak allocated bytes beside phase 4's
    target-only numbers, and how many grid streams equal phase 4's (in
    bf16 the verify's R = 40 products round otherwise than decode's R =
    8 ones, so a flip is printed with its margin, not failed: phase 5f
    holds the equality in fp32). Returns the launch counts by path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import (PagingConfig, ServeConfig, ServingEngine,
                                     SpecConfig)

    arch = get_arch("qwen1.5-0.5b")
    draft = dataclasses.replace(arch, num_layers=1)
    new_tokens = 32
    per_replay, per_group = spec_launches(arch.num_layers, draft.num_layers,
                                          SPEC_K)
    out = {}
    for tag, paged in (("spec", False), ("spec-paged", True)):
        config = ServeConfig(slots=SLOTS, max_len=MAX_LEN, seed=0,
                             lookahead=1, spec=SpecConfig(draft=draft, k=SPEC_K),
                             paging=PagingConfig(paged=paged, page_size=PAGE))
        torch.cuda.reset_peak_memory_stats()
        model = init_params(arch, 0)  # phase 4's target weights
        engine = ServingEngine(arch, {"target": model,
                                      "draft": init_params(draft, 1)},
                               config=config)
        if engine.decode.graph is None:
            raise AssertionError(f"[{tag}] no CUDA graph captured")
        if engine.decode.launches != per_replay:
            raise AssertionError(f"[{tag}] a replay launches "
                                 f"{engine.decode.launches}, expected "
                                 f"{per_replay}")
        prompts = (shared_set(arch.vocab_size) if paged
                   else phase4_prompts(arch.vocab_size))
        ops.reset_launches()
        t0 = time.perf_counter()
        streams, steps, groups, n_shared, peak = drive(engine, prompts,
                                                       new_tokens, owner=paged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for rid, toks in streams.items():
            if len(toks) != new_tokens or not all(0 <= t < arch.vocab_size
                                                   for t in toks):
                raise AssertionError(f"[{tag}] rid {rid}: bad stream {toks}")
        want = {"xfer_matmul": per_replay["xfer_matmul"] * steps
                + per_group["xfer_matmul"] * groups,
                "paged_attention": per_replay["paged_attention"] * steps,
                "flash_attention": per_group["flash_attention"] * groups}
        check_paged_counts(tag, counts, PATH_KERNELS[tag], want)
        stats = engine.step_stats()
        peak_bytes = torch.cuda.max_memory_allocated()
        log(f"[{tag}] {len(streams)} requests, {steps} decode steps, {groups} "
            f"prefill groups ({n_shared} shared), {wall:.3f} s wall; launches "
            f"{counts} (exact: {per_replay} a replay, {per_group} a group)")
        log(f"[{tag}] step p50 {stats['step_p50_ms']:.3f} ms (target-only "
            f"phase 4: {dense_stats['step_p50_ms']:.3f}), tokens/s "
            f"{stats['tokens_per_s']:.1f} ({dense_stats['tokens_per_s']:.1f}),"
            f" accepted_tokens_mean {stats['accepted_tokens_mean']:.4f}, "
            f"draft_acceptance {stats['draft_acceptance']:.4f}, peak allocated"
            f" {peak_bytes} bytes ({dense_stats['peak_allocated_bytes']}); "
            f"pages in use at most {peak}")
        log(f"[{tag}] step_stats {json.dumps(stats)}")
        log(f"[{tag}] prefill_stats {json.dumps(engine.prefill_stats())}")
        if not paged:
            compare_streams(tag, model, prompts, streams, dense_streams,
                            "phase 4's target-only streams", limit=None)
        out[tag] = counts
        del engine, model
        torch.cuda.empty_cache()
    return out


def host_key(seed: int, rid: int, splits: int):
    """``split``^splits (the carried half) of ``fold_in(PRNGKey(seed),
    rid)``, on the host."""
    import torch
    from repro_torch.serving import sampler as SMP
    key = SMP.fold_in(SMP.prng_key(seed), torch.tensor([rid]))
    for _ in range(splits):
        key = SMP.split(key)[0]
    return key[0]


def serve_sampled(dense_stats: dict) -> dict:
    """Phase 4i: full-width qwen1.5-0.5b in bf16 on the grid, phase 4's 16
    prompts of 32 new tokens, sampled with top-k (k 50, T 0.8) and with
    temperature (T 0.8), seed 0. Launch counts exact (the greedy path's);
    every request gets its budget; each slot's key after the drain
    equals ``split``^n of its last request's ``fold_in(PRNGKey(0), rid)``
    recomputed on the host, n = 1 (the admission's draw) + the decode
    steps since that admission (the plain step draws for every slot).
    Prints step p50 beside greedy's (phase 4): the sampler's cost a
    step. Returns the launch counts by path."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.registry import init_params
    from repro_torch.serving import SamplingParams, ServeConfig, ServingEngine

    arch = get_arch("qwen1.5-0.5b")
    layers, new_tokens = arch.num_layers, 32
    per_pass = 7 * layers + 1
    prompts = phase4_prompts(arch.vocab_size)
    out = {}
    for tag, sp in (("top-k", SamplingParams("top_k", 0.8, 50)),
                    ("temperature", SamplingParams("temperature", 0.8))):
        torch.cuda.reset_peak_memory_stats()
        engine = ServingEngine(arch, init_params(arch, 0), config=ServeConfig(
            slots=SLOTS, max_len=MAX_LEN, seed=0, lookahead=1, sampling=sp))
        decodes, admitted = [0], {}
        decode, admit = engine.decode, engine.scheduler.admit

        def counted_decode():
            decodes[0] += 1
            return decode()

        def tracked_admit(model, caches, state):
            before = dict(engine.scheduler.active)
            result = admit(model, caches, state)
            for slot, req in engine.scheduler.active.items():
                if req is not None and before.get(slot) is not req:
                    admitted[slot] = (req.rid, decodes[0])
            return result

        engine.decode, engine.scheduler.admit = counted_decode, tracked_admit
        ops.reset_launches()
        t0 = time.perf_counter()
        streams, steps, groups, _, _ = drive(engine, prompts, new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for rid, toks in streams.items():
            if len(toks) != new_tokens or not all(0 <= t < arch.vocab_size
                                                   for t in toks):
                raise AssertionError(f"[sampled-{tag}] rid {rid}: bad stream "
                                     f"{toks}")
        check_paged_counts(f"sampled-{tag}", counts, PATH_KERNELS["sampled"],
                           {"xfer_matmul": per_pass * (steps + groups),
                            "paged_attention": layers * steps,
                            "flash_attention": layers * groups})
        keys = engine.state.rng.cpu()
        for slot, (rid, at) in sorted(admitted.items()):
            want = host_key(0, rid, 1 + decodes[0] - at)
            if not torch.equal(keys[slot], want):
                raise AssertionError(f"[sampled-{tag}] slot {slot} (rid {rid}) "
                                     f"holds key {keys[slot].tolist()}, the "
                                     f"host's chain gives {want.tolist()}")
        stats = engine.step_stats()
        distinct = sum(len(set(t)) for t in streams.values()) / len(streams)
        log(f"[sampled-{tag}] {len(streams)} requests, {steps} decode steps, "
            f"{groups} prefill groups, {wall:.3f} s wall; launches {counts} "
            f"(exact); {len(admitted)} slot keys equal the host's chain; "
            f"{distinct:.1f} distinct tokens a stream")
        log(f"[sampled-{tag}] step p50 {stats['step_p50_ms']:.3f} ms against "
            f"greedy's {dense_stats['step_p50_ms']:.3f} (phase 4): "
            f"{stats['step_p50_ms'] - dense_stats['step_p50_ms']:+.3f} ms a "
            f"step; tokens/s {stats['tokens_per_s']:.1f} "
            f"({dense_stats['tokens_per_s']:.1f})")
        log(f"[sampled-{tag}] step_stats {json.dumps(stats)}")
        log(f"[sampled-{tag}] prefill_stats "
            f"{json.dumps(engine.prefill_stats())}; peak_allocated_bytes "
            f"{torch.cuda.max_memory_allocated()}")
        out[tag] = counts
        # the wrappers hold the engine's step and scheduler: drop them too,
        # so that the next run's peak bytes are its own
        del engine, decode, admit, counted_decode, tracked_admit
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 5e: the paged pool, card vs CPU
# --------------------------------------------------------------------------

def parity_paged(dev) -> None:
    """Phase 5e: full-width qwen1.5-0.5b with the depth cut to 4 layers,
    seeded fp32 weights on the card and on the CPU, on fp pools and on
    int8 pools (``QuantConfig(kv="int8")``). The owner's 200-token prompt
    is prefilled into pages 1-4; three sharers copy page 4 on write and
    prefill only their tails against the gathered prefix; then 5 decode
    steps of all four through the page table, fed the CPU's greedy
    tokens. Logits within PARITY_TOL of max |logit|, tokens equal, pool
    contents (every page but the null page) within PARITY_TOL of the
    leaf's max (int8 payloads within one level, scales within
    PARITY_TOL)."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    from repro_torch.serving import pages as PG
    from repro_torch.serving.scheduler import (bucket_len, prefill_rows,
                                               prefill_shared)

    tag = "parity-paged"
    arch = dataclasses.replace(get_arch("qwen1.5-0.5b"), num_layers=4)
    cpu_model = init_params(arch, 1, device="cpu")  # fp32
    card_model = copy.deepcopy(cpu_model).to(dev)
    prompts = shared_set(arch.vocab_size)[:4]
    lens = np.array([len(p) for p in prompts], np.int32)
    m, steps, n_full = SYS_LEN, 5, SYS_LEN // PAGE
    span = n_full + 1  # the prefix ends inside page n_full + 1
    table = np.zeros((4, MAX_LEN // PAGE), np.int32)
    table[0, :span] = 1 + np.arange(span)
    fresh = span + 1
    for i in range(1, 4):  # aliased full pages, a private copy of the frontier
        need = -(-(int(lens[i]) + steps) // PAGE)
        table[i, :n_full] = table[0, :n_full]
        table[i, n_full:need] = fresh + np.arange(need - n_full)
        fresh += need - n_full
    n_pages = fresh
    suffix = np.zeros((3, bucket_len(int(lens.max()) - m, MAX_LEN)), np.int32)
    for i in range(1, 4):
        suffix[i - 1, :lens[i] - m] = prompts[i][m:]
    owner = np.zeros((1, bucket_len(m, MAX_LEN)), np.int32)
    owner[0, :m] = prompts[0]

    def run(model, kv_quant, feed=None):
        d = model.device
        t = torch.from_numpy(table).to(d)
        pools = PG.make_paged_caches(arch, n_pages, PAGE, device=d,
                                     dtype=torch.float32, kv_quant=kv_quant)
        rows, lg0 = prefill_rows(model, torch.from_numpy(owner).to(d),
                                 torch.from_numpy(lens[:1]).to(d),
                                 kv_quant=kv_quant)
        PG.splice_pages(pools, rows, t[:1])
        PG.copy_pages(pools, table[1:, n_full].tolist(),
                      [int(table[0, n_full])] * 3)
        rows, lg1 = prefill_shared(model, pools, t[1:, :span], m,
                                   torch.from_numpy(suffix).to(d),
                                   torch.from_numpy(lens[1:]).to(d))
        PG.splice_pages(pools, rows, t[1:])
        out = [torch.cat([lg0, lg1])[:, -1].float().cpu()]
        chosen = [out[-1].argmax(-1).to(torch.int32)]
        pos = torch.from_numpy(lens).to(d)[:, None]
        for j in range(steps):
            tok = (feed[j] if feed is not None else chosen[-1]).to(d)[:, None]
            hidden, pools = model(tok, caches=pools, positions=pos,
                                  page_table=t)
            out.append(model.logits(hidden)[:, -1].float().cpu())
            chosen.append(out[-1].argmax(-1).to(torch.int32))
            pos = pos + 1
        return out, chosen, [{k: v[1:].cpu() for k, v in p.items()}
                             for p in pools]

    for kv_quant in (False, True):
        label = "int8 pools" if kv_quant else "fp pools"
        t0 = time.perf_counter()
        with torch.no_grad():
            want, want_tok, want_pool = run(cpu_model, kv_quant)
            got, got_tok, got_pool = run(card_model, kv_quant, feed=want_tok)
        worst = 0.0
        for j in range(steps + 1):
            rel = float((got[j] - want[j]).abs().max()) / float(want[j].abs().max())
            worst = max(worst, rel)
            log(f"[{tag}] {label} position {j}: logits max rel err {rel:.3e}, "
                f"tokens card {got_tok[j].tolist()} cpu {want_tok[j].tolist()}")
            if not torch.equal(got_tok[j], want_tok[j]):
                raise AssertionError(f"[{tag}] {label}: greedy token differs "
                                     f"at position {j}")
        pool_err, level = 0.0, 0
        for g, w in zip(got_pool, want_pool):
            for name in w:
                if w[name].dtype == torch.int8:
                    level = max(level, int((g[name].int() - w[name].int())
                                           .abs().max()))
                else:
                    pool_err = max(pool_err, float((g[name] - w[name]).abs().max())
                                   / float(w[name].abs().max()))
        log(f"[{tag}] {label}: prefill + {steps} decode steps on both in "
            f"{time.perf_counter() - t0:.1f} s; worst logits rel err "
            f"{worst:.3e}, pool rel err {pool_err:.3e}"
            + (f", int8 payloads within {level} level(s)" if kv_quant else ""))
        if worst > PARITY_TOL or pool_err > PARITY_TOL or level > 1:
            raise AssertionError(f"[{tag}] {label}: card vs CPU beyond "
                                 f"{PARITY_TOL} (logits {worst:.3e}, pool "
                                 f"{pool_err:.3e}, int8 levels {level})")
    del card_model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 5f: speculative and sampled serving, card vs CPU
# --------------------------------------------------------------------------

def sample_margin(model, prompt, prefix, rid: int, sp, seed: int = 0) -> float:
    """The top-2 margin, over max |logits / T|, of ``logits / T + gumbel``
    (top-k masked) at the draw that gave token ``len(prefix)`` of request
    ``rid`` (its key: ``fold_in(PRNGKey(seed), rid)`` carried through one
    split per token before it, then split for the draw); one full causal
    forward of ``model``, no cache."""
    import numpy as np
    import torch
    from repro_torch.serving import sampler as SMP
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(toks).to(model.device)[None])
        row = model.logits(hidden[:, -1]).float().cpu() / sp.temperature
    if sp.method == "top_k":
        row = SMP.top_k_mask(row, sp.top_k)
    key = host_key(seed, rid, len(prefix))[None]
    z = row + SMP.gumbel(SMP.split(key)[1], row.shape[-1])
    top = torch.topk(z[0], 2).values
    return float(top[0] - top[1]) / float(row[torch.isfinite(row)].abs().max())


def liven_(model, seed: int) -> None:
    """Seeded norms and qkv biases (0.5 N(0, 1)) and 8x output and down
    projections on every attention block of ``model``, in place, so that
    greedy streams of random weights do not repeat one token and a cold
    draft's proposals are rejected."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.layers:
            for name in ("ln1", "ln2", "bq", "bk", "bv"):
                if hasattr(layer, name):
                    p = getattr(layer, name)
                    p.copy_(0.5 * torch.randn(p.shape, generator=gen))
            layer.wo.mul_(8.0)
            layer.mlp.w_down.mul_(8.0)


def parity_spec(dev) -> None:
    """Phase 5f: qwen1.5-0.5b at full width with the target's depth cut to
    4 and a 1-layer draft, seeded fp32 weights, k = 3, on the grid and on
    the paged pool (pages of 64), 4 slots, 4 requests of 16-120 prompt
    tokens and 12 new ones (norms and biases seeded, ``liven_``; the draft
    the target's first layer). On the card and on the CPU: speculative
    greedy streams, and top-k (k 50, T 0.8) speculative streams with the
    same seed; on the card also the target alone and a self-draft
    (every proposal accepted), greedy. The card's speculative streams
    equal the CPU's and (greedy) the card's target-only streams; a
    divergence is allowed only where its top-2
    margin (of the logits, or of logits / T + gumbel for the sampled
    streams, over their max magnitude) is under PARITY_TOL."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import init_params
    from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                     ServeConfig, ServingEngine, SpecConfig)

    tag = "parity-spec"
    arch = dataclasses.replace(get_arch("qwen1.5-0.5b"), num_layers=4)
    draft = dataclasses.replace(arch, num_layers=1)
    cpu_t = init_params(arch, 1, device="cpu")  # fp32
    liven_(cpu_t, 3)
    # the draft: the target's embedding, first layer and final norm, so
    # that some proposals are accepted and some rejected
    cpu_d = init_params(draft, 2, device="cpu")
    cpu_d.load_state_dict({k: v for k, v in cpu_t.state_dict().items()
                           if not k.startswith("layers.")
                           or k.startswith("layers.0.")})
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, arch.vocab_size, size=int(rng.randint(16, 121)))
               .astype(np.int32) for _ in range(4)]
    top_k = SamplingParams("top_k", 0.8, 50)

    def run(device, paged, sp, spec="layer0"):
        """Streams and step stats of one engine; ``spec``: the draft (the
        target's first layer, "self": the target itself) or None."""
        target = copy.deepcopy(cpu_t)
        params, cfg = target, None
        if spec is not None:
            d_arch, d_model = (arch, cpu_t) if spec == "self" else (draft, cpu_d)
            params = {"target": target, "draft": copy.deepcopy(d_model)}
            cfg = SpecConfig(draft=d_arch, k=3)
        eng = ServingEngine(arch, params, device=device, dtype=torch.float32,
                            config=ServeConfig(
                                slots=4, max_len=256, seed=0, lookahead=1,
                                sampling=sp, spec=cfg,
                                paging=PagingConfig(paged=paged,
                                                    page_size=PAGE)))
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=12))
        with torch.no_grad():
            eng.run_until_drained()
        streams = {r.rid: list(r.out_tokens) for r in eng.completed}
        stats = eng.step_stats()
        del eng
        return streams, stats

    def check(label, got, want, sp):
        same = 0
        for rid in sorted(want):
            g, w = got[rid], want[rid]
            if g == w:
                same += 1
                continue
            j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     min(len(g), len(w)))
            margin = (top2_margin(cpu_t, prompts[rid], w[:j])
                      if sp.method == "greedy"
                      else sample_margin(cpu_t, prompts[rid], w[:j], rid, sp))
            log(f"[{tag}] {label}: rid {rid} diverges at token {j}, top-2 "
                f"margin {margin:.3e}")
            if margin > PARITY_TOL:
                raise AssertionError(f"[{tag}] {label}: rid {rid} differs at "
                                     f"token {j} with margin {margin:.3e} > "
                                     f"{PARITY_TOL}")
        log(f"[{tag}] {label}: {same}/{len(want)} streams equal")

    for paged in (False, True):
        where = "pool" if paged else "grid"
        t0 = time.perf_counter()
        cpu_g, cpu_gs = run("cpu", paged, SamplingParams())
        card_g, card_gs = run(dev, paged, SamplingParams())
        card_plain, _ = run(dev, paged, SamplingParams(), spec=None)
        check(f"{where} greedy spec, card vs CPU", card_g, cpu_g,
              SamplingParams())
        check(f"{where} greedy spec vs target-only, card", card_g, card_plain,
              SamplingParams())
        card_self, self_stats = run(dev, paged, SamplingParams(), spec="self")
        check(f"{where} greedy self-draft spec vs target-only, card",
              card_self, card_plain, SamplingParams())
        if self_stats["draft_acceptance"] < 0.99:
            raise AssertionError(f"[{tag}] {where}: the self-draft accepted "
                                 f"{self_stats['draft_acceptance']:.4f}")
        cpu_s, _ = run("cpu", paged, top_k)
        card_s, card_ss = run(dev, paged, top_k)
        check(f"{where} top-k spec, card vs CPU", card_s, cpu_s, top_k)
        log(f"[{tag}] {where}: greedy accepted_tokens_mean card "
            f"{card_gs['accepted_tokens_mean']:.4f} cpu "
            f"{cpu_gs['accepted_tokens_mean']:.4f}, draft_acceptance card "
            f"{card_gs['draft_acceptance']:.4f} cpu "
            f"{cpu_gs['draft_acceptance']:.4f}; self-draft "
            f"accepted_tokens_mean {self_stats['accepted_tokens_mean']:.4f}; "
            f"top-k accepted_tokens_mean {card_ss['accepted_tokens_mean']:.4f}; "
            f"{time.perf_counter() - t0:.1f} s")
    del cpu_t, cpu_d
    torch.cuda.empty_cache()


# kernels that must compile without spills: every flash_attention
# instance (flash_split_kernel, flash_tc_kernel, flash_terms_kernel),
# both rglru_scan routes,
# both mlstm_chunkwise kernels (fp32 mlstm_kernel, bf16 mlstm_tc_kernel),
# xfer_matmul's and quant_matmul's decode and tensor-core kernels and both
# paged_attention bodies (paged_split_kernel, fp and int8 pools)
NO_SPILL = ("flash_split_kernel", "flash_tc_kernel", "flash_terms_kernel",
            "rglru_ring_kernel", "rglru_rows_kernel",
            "mlstm_kernel", "mlstm_tc_kernel",
            "stream_rows_kernel", "stream_mma_kernel", "stream_cols_kernel",
            "stream_mma_q8_kernel", "stream_cols_q8_kernel", "tc_kernel",
            "wg_kernel", "paged_split_kernel")


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


def kernel_table(entries: dict, counts: dict) -> list:
    """The kernel line's rows: each kernel's timed entry with its launches
    on its main path (the first path of PATH_KERNELS that runs it) and on
    every path."""
    from repro_torch.kernels import ops
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
                    "ssm", "d128", "d128_gqa", "fp32", "n1", "prefix", "own",
                    "pool", "note",
                    "variant", "multi_query",
                    "every_length", "shapes", "ptxas", "device_ms",
                    "library_device_ms", "yardstick_device_ms", "bit_stable"):
            if key in e:
                row[key] = e[key]
        kernels.append(row)
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    started = time.perf_counter()

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
    counts = {}
    counts["fp"], dense_streams, dense_stats = serve_full_width()
    counts["int8"] = serve_full_width(int8=True)[0]
    # ---- phase 4c: the hybrid path (recurrentgemma-2b)
    counts["hybrid"] = serve_hybrid()
    # ---- phase 4d: the ssm path (xlstm-350m)
    counts["ssm"] = serve_xlstm()
    # ---- phase 4e and 4f: the paged pool with prefix reuse, bf16 and INT8
    counts["paged"] = serve_paged(dense_streams)
    counts["paged-int8"] = serve_paged(dense_streams, int8=True)
    # ---- phase 4h: speculative serving, grid and pool (k = 4)
    counts.update(serve_spec(dense_streams, dense_stats))
    # ---- phase 4i: sampled serving (top-k, temperature) on the grid
    sampled = serve_sampled(dense_stats)
    counts["sampled"] = {name: sum(c[name] for c in sampled.values())
                         for name in counts["fp"]}
    # ---- phase 4j: deepseek-moe-16b at full width and depth, grid and pool
    counts.update(serve_moe())
    # ---- phase 4k: minitron-8b, yi-9b and phi3-medium-14b at full width
    counts["dense-d128"] = serve_dense_d128()
    # ---- phase 4g: the captured step against the eager step on every
    # path, and a trace of steady steps, graph and eager
    graph_vs_eager()
    trace_steps()

    # ---- phase 5 and 5b: card vs CPU at full width, fp and INT8
    parity_full_width(dev)
    # ---- phase 5c: the same for the hybrid, depth cut to 4 layers
    parity_hybrid(dev)
    # ---- phase 5d: the same for the ssm family, depth cut to 4 layers
    parity_xlstm(dev)
    # ---- phase 5e: the paged pool (fp and int8), depth cut to 4 layers
    parity_paged(dev)
    # ---- phase 5f: speculative and sampled streams, depth cut to 4 layers
    parity_spec(dev)
    # ---- phase 5g: the MoE family and relu2 at full width, cut depth
    parity_moe(dev)

    kernels = kernel_table(entries, counts)
    log(f"[total] {time.perf_counter() - started:.1f} s, the build included")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
