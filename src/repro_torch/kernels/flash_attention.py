"""``flash_attention``: causal / windowed / prefix-LM online-softmax
prefill attention, with per-row key lengths.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``, fp body ``_flash_body``) with
the hand-written CUDA kernels of ``csrc/flash_attention.cu``. q ``[BH, S,
D]``, k/v ``[BH, T, D]`` (kv already broadcast across groups), query and
key positions from 0; fp32 scores scaled by 1/sqrt(D), running
max/sum/accumulator in fp32, one normalisation at the end.

Bound on the H100: at this path's prefill shapes the work is operation
bound (``4·D`` flops per visible query-key pair); the score matrix
never reaches device memory, and kv tiles past the causal diagonal or
wholly before the window are skipped. A loop over kv tiles inside one
block per (bh, query block) takes the place of the TPU's sequential grid
axis; the TPU tile sizes ``bq``/``bk`` do not carry over. The kernel
instance follows q's dtype, the storage of k/v and the head dim:

- bf16 q with fp k/v (every serving prefill, the fp shared-prefix entry
  too), D in 16..256: tensor cores (``wgmma`` for q kᵀ and p v, two
  warpgroups of 64 queries a block, three at D = 128, k/v tiles of 64
  keys through a ``cp.async`` ring). P is rounded to bf16 before p v,
  where the TPU body multiplies f32 p by f32 v: a rounding the reference
  does not have, held to the bf16 tolerance
  (:func:`repro_torch.kernels.ref.flash_attention_tiles_ref` is the
  plain mirror of the tile order and that rounding).
- every other form at D = 16, 32 and 64 (fp32 q with fp32 k/v, the INT8
  path's prefill; the int8 body and the int8-prefix entry with fp32 or
  bf16 q): the same tensor-core products on exact bf16 terms (int8 widened as it
  is staged, fp32 q, p and k/v split in three), the int8 scales applied
  in f32 to the scores (``k_scale``) and folded into p (``v_scale``), a
  query block's k/v tiles split between two warpgroups and merged in a
  fixed order, D = 16 and 32 zero-padded to 64
  (:func:`repro_torch.kernels.ref.flash_attention_tiles_ref` with
  ``terms=True`` is its plain mirror). fp32 results depart from the
  plain version in the order of the sums and in dropped term products
  below 2^-24 of each product (no TF32).
- the rest (fp32 or int8 at D = 128 and 256, no serving path under
  INT8): CUDA cores, fp32 FMA, ``D / 32`` threads per query row.

:func:`kernel_for` names the kernel instance of a call.

Operands are made contiguous, and copied when their base is off 16
bytes (the tensor-core kernels copy rows in 16-byte pieces).

Like the TPU kernel its causal form needs no length operand: on a
right-padded batch the valid query rows are exact and the padded tail's
rows are not (they are causally invisible to valid rows and their cache
entries are invalidated by the scheduler). Two masking forms go past the
TPU kernel, as the reference's ``layers._mask`` has them:

- ``kv_len`` [B] int32 (BH = B · heads, heads folded into the batch as
  the model's ``layers`` fold them): keys at or past row b's length are
  masked, with ``causal=False`` the encoder's bidirectional attention
  over right-padded frames and the decoder's cross-attention prefill
  (S queries over T ≠ S encoder positions). Keys past a length are
  never read. A row of length 0 has no visible key: its output is 0
  (the reference's masked softmax averages V there; serving refuses a
  request with 0 source frames, so there only inert slots have such
  rows). The kernel reads the lengths on the card, so
  they cost no host sync.
- ``prefix_len`` P > 0 with ``causal=True``: the prefix-LM mask, key kp
  visible to query qi when ``kp <= qi or kp < P`` (paligemma's patch
  prefix attended both ways). One int per launch: a vlm prefill group
  shares one patch count.

Both go to the same fp instances (``flash_tc_kernel``,
``flash_terms_kernel``, ``flash_split_kernel``); the int8 body and the
shared-prefix entry take neither.

INT8 k/v (``k_scale``/``v_scale`` ``[BH, T, 1]`` f32, the TPU kernel's
``_flash_kernel_q8``) go to the int8 instances of the same source
(:func:`flash_attention_q8`); the fp extent never exists in device
memory.

:func:`prefix_attention` is the shared-prefix prefill of the paged
serving path (``models.blocks``): the queries of a suffix attend a
gathered prefix, fp or int8 with per-token scales and valid below
``pre_len`` (rows past it, and their scales, are never read), then the
fresh fp suffix, causally, with one online softmax. ``pre_len`` is one
int per launch (a shared group has one prefix length). An fp prefix
launches the fp kernels, an int8 one the int8 instances. Off the
tensor cores (D >= 128) those round each dequantised prefix element to
``q.dtype`` as the reference casts its dequantised prefix; the
tensor-core forms take it exactly, scales in f32, for bf16 q as well (a
difference inside the bf16 tolerance).

Training (``torch.is_grad_enabled()`` and q, k or v requiring grad)
goes through an ``autograd.Function``: its forward launches the fp
kernels as ``csrc/flash_attention_train.cu`` builds them
(:func:`flash_attention_lse`: ``flash_attention.cu`` with its training
hooks on, also writing each row's log-sum-exp ``lse`` [BH, S] f32), its
backward the hand-written :func:`flash_attention_bwd`
(``csrc/flash_attention_bwd.cu``, FlashAttention-2's backward from
``lse``), at head dims 64 and 128, causal or not, S queries over T keys
(the dense and MoE families' causal self-attention; the encdec family's
bidirectional encoder and its decoder's cross-attention). The forms with
no backward kernel (``window``, ``kv_len``, ``prefix_len``, int8 K/V,
other head dims on the card) raise ``NotImplementedError`` at the
forward. On CPU tensors the same Function runs
:func:`ref.flash_attention_lse_ref` and :func:`ref.flash_attention_bwd_ref`.

A CPU tensor takes the plain version (:func:`plain`,
:func:`prefix_plain`); a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts the fp kernels' launches (the fp
prefix form and the training forward too), ``flash_attention_q8.launches``
the int8 template's (both entries), ``flash_attention_bwd.launches`` the
backward's (one C entry: its three kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda,
                                         check_device, check_dtype,
                                         check_float, launch)
from repro_torch.kernels.ref import flash_attention_bwd_ref as bwd_plain
from repro_torch.kernels.ref import flash_attention_lse_ref as lse_plain
from repro_torch.kernels.ref import flash_attention_ref as plain
from repro_torch.kernels.ref import prefix_attention_ref as prefix_plain

HEAD_DIMS = (16, 32, 64, 128, 256)
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _I, _I, _F, _I)
_ARGTYPES_Q8 = (_VP,) * 6 + (_I, _I, _I, _I, _I, _I, _F, _I)
_ARGTYPES_PREFIX = (_VP,) * 5 + (_I, _I, _VP, _VP, _VP, _I, _I, _I, _F, _I)
_ARGTYPES_LSE = (_VP,) * 5 + (_I, _I, _I, _I, _I, _F, _I)
_ARGTYPES_BWD = (_VP,) * 10 + (_I, _I, _I, _I, _I, _F, _I)
#: head dims of the training kernels on the card (qwen1.5-0.5b's 64; yi-9b,
#: phi3-medium-14b and minitron-8b's 128)
TRAIN_HEAD_DIMS = (64, 128)
#: the ROADMAP item that ports the forms without a backward kernel
TRAIN_TODO = "ROADMAP A12b"
#: flash_attention_bwd's bf16 kernels (``csrc/flash_attention_bwd.cu``,
#: namespace wgb): consumer warpgroups a block (64 own rows each), rows
#: of a streamed tile, stages of the TMA ring
BWD_CONSUMERS, BWD_TILE, BWD_STAGES = 2, 64, 4


def _schedule(items: int, grid: int) -> list:
    """The items each persistent block takes: block b items b, 2 grid - 1
    - b, 2 grid + b, ... (the order turning each round)."""
    return [[r * grid + (grid - 1 - b if r % 2 else b)
             for r in range(-(-items // grid))
             if r * grid + (grid - 1 - b if r % 2 else b) < items]
            for b in range(grid)]


def bwd_plan(bh: int, s: int, d: int, sms: int, *, t: int = None,
             causal: bool = True) -> dict:
    """The launch of ``flash_attention_bwd``'s bf16 kernels for q [bh, s,
    d] over k, v [bh, t, d] (``t`` default ``s``) on a card of ``sms``
    SMs: ``items`` (dkdv's: head, block of 128 keys from the first) and
    ``dq_items`` (head, block of 128 queries from the last), item i at
    head ``i % bh`` and block ``i // bh`` so that the items with the most
    tiles come first; ``grid`` and ``dq_grid`` (persistent blocks, one an
    SM: block b takes items b, 2 grid - 1 - b, 2 grid + b, ...,
    ``block_items`` and ``dq_block_items``); ``threads`` (two consumer
    warpgroups and a producer); ``own`` and ``tile`` rows; ``stages`` of
    the ring; ``own_bufs`` (buffers of the own tiles, two at D = 64 so
    that the next item's load while one runs); the streamed tiles each
    dkdv item (causal: from the diagonal on; else all of S's) and dq
    item (causal: up to it; else all of T's) visits; and each kernel's
    dynamic shared memory: 1024 bytes of alignment, the own buffers (K, V
    or Q, dO), the ring of streamed pairs, dkdv's lse and delta a stage,
    the full and empty mbarriers."""
    t = s if t is None else t
    own = BWD_CONSUMERS * 64
    kv_blocks, q_blocks = -(-t // own), -(-s // own)
    q_tiles, k_tiles = -(-s // BWD_TILE), -(-t // BWD_TILE)
    items, dq_items = bh * kv_blocks, bh * q_blocks
    bufs = 2 if d == 64 else 1
    grid, dq_grid = min(items, sms), min(dq_items, sms)
    ring = (1024 + bufs * 2 * own * d * 2
            + BWD_STAGES * 2 * BWD_TILE * d * 2)
    bars = 8 * (2 * BWD_STAGES + 2 * bufs)
    q0 = [(q_blocks - 1 - i // bh) * own for i in range(dq_items)]
    return dict(items=items, grid=(grid,), dq_items=dq_items,
                dq_grid=(dq_grid,), threads=(BWD_CONSUMERS + 1) * 128,
                own=own, tile=BWD_TILE, stages=BWD_STAGES, own_bufs=bufs,
                block_items=_schedule(items, grid),
                dq_block_items=_schedule(dq_items, dq_grid),
                dkdv_tiles=[max(q_tiles - (i // bh * own // BWD_TILE
                                           if causal else 0), 0)
                            for i in range(items)],
                dq_tiles=[min(k_tiles, -(-(q + own) // BWD_TILE))
                          if causal else k_tiles for q in q0],
                dkdv_smem=ring + BWD_STAGES * 2 * BWD_TILE * 4 + bars,
                dq_smem=ring + bars)


def kernel_for(dtype: torch.dtype, d: int, prefix_q8: bool = False,
               main_q8: bool = False) -> str:
    """The ``csrc/flash_attention.cu`` kernel that a call with q in
    ``dtype`` and head dim ``d`` launches (an int8 prefix, or int8 k/v in
    the body): ``flash_tc_kernel`` for bf16 with fp k/v,
    ``flash_terms_kernel`` for every other form at D <= 64,
    ``flash_split_kernel`` for those at D = 128 and 256."""
    if dtype == torch.bfloat16 and not (prefix_q8 or main_q8):
        return "flash_tc_kernel"
    return "flash_terms_kernel" if d <= 64 else "flash_split_kernel"


def _check_scales(name: str, k, v, k_scale, v_scale) -> tuple:
    """() for fp k/v, else the scales after checking them: both given,
    [BH, T, 1] f32 for int8 k/v [BH, T, D]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both scales, or neither")
    if k_scale is None:
        return ()
    want = tuple(k.shape[:2]) + (1,)
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)} for k {tuple(k.shape)}")
    check_dtype(name, torch.int8, k, v)
    check_dtype(name, torch.float32, k_scale, v_scale)
    return k_scale, v_scale


def _staged(*tensors: torch.Tensor) -> tuple:
    """Each operand contiguous, with its base on 16 bytes."""
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return tuple(out)


def _check_head_dim(name: str, d: int) -> None:
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")


def _check_forms(bh: int, kv_len, prefix_len: int, causal: bool) -> int:
    """Heads per ``kv_len`` row (1 without lengths), after checking the
    two masking forms' operands."""
    if prefix_len < 0 or (prefix_len and not causal):
        raise ValueError(f"flash_attention: prefix_len {prefix_len} needs "
                         f"causal=True and must be >= 0")
    if kv_len is None:
        return 1
    if kv_len.dim() != 1 or kv_len.shape[0] == 0 \
            or bh % kv_len.shape[0] != 0:
        raise ValueError(f"flash_attention: kv_len {tuple(kv_len.shape)} "
                         f"for BH = {bh}")
    if kv_len.dtype != torch.int32:
        raise TypeError("flash_attention: kv_len must be int32")
    return bh // kv_len.shape[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    k_scale: torch.Tensor = None, v_scale: torch.Tensor = None,
                    causal: bool = True, window: int = 0,
                    kv_len: torch.Tensor = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q: [BH, S, D]; k, v: [BH, T, D] (int8 with ``k_scale``/``v_scale``
    [BH, T, 1] f32) -> [BH, S, D] in ``q.dtype``. ``kv_len`` [B] int32
    (B dividing BH): row bh's keys at or past ``kv_len[bh // (BH / B)]``
    masked; ``prefix_len`` (with ``causal``): keys below it visible to
    every query. Neither with int8 K/V on the card."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_trainable(q, window=window, kv_len=kv_len,
                         prefix_len=int(prefix_len),
                         int8=k_scale is not None or v_scale is not None)
        return _Attention.apply(q, k, v, bool(causal))
    prefix_len = int(prefix_len)
    heads = _check_forms(q.shape[0], kv_len, prefix_len, causal)
    scales = _check_scales("flash_attention", k, v, k_scale, v_scale)
    lens = () if kv_len is None else (kv_len,)
    if all(t.device.type == "cpu" for t in (q, k, v, *scales, *lens)):
        return plain(q, k, v, k_scale=k_scale, v_scale=v_scale,
                     causal=causal, window=window, kv_len=kv_len,
                     prefix_len=prefix_len)
    if scales:
        if lens or prefix_len:
            raise NotImplementedError("flash_attention: the int8 body takes "
                                      "neither kv_len nor prefix_len")
        return flash_attention_q8(q, k, v, *scales, causal=causal,
                                  window=window)
    check_cuda("flash_attention", q, k, v)
    if lens:
        check_device("flash_attention", q, kv_len)
        kv_len = kv_len.contiguous()
    bh, s, d = q.shape
    t = k.shape[1]
    _check_head_dim("flash_attention", d)
    q, k, v = _staged(q, k, v)
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention: empty key sequence")
    launch("flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), bh, s, t, d, int(causal),
           int(window), kv_len.data_ptr() if lens else None, heads,
           prefix_len, 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype])
    flash_attention.launches += 1
    return out


def flash_attention_q8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """The int8 body on CUDA tensors, shapes checked by
    :func:`flash_attention` (its entry point): int8 k/v, f32 scales, q
    fp32 or bf16."""
    check_device("flash_attention_q8", q, k, v, k_scale, v_scale)
    check_float("flash_attention_q8", q)
    bh, s, d = q.shape
    t = k.shape[1]
    _check_head_dim("flash_attention_q8", d)
    q, k, v, k_scale, v_scale = _staged(q, k, v, k_scale, v_scale)
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention_q8: empty key sequence")
    launch("flash_attention_q8", _ARGTYPES_Q8, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
           out.data_ptr(), bh, s, t, d, int(causal), int(window),
           1.0 / math.sqrt(d), DTYPE_CODES[q.dtype], source="flash_attention")
    flash_attention_q8.launches += 1
    return out


def prefix_attention(q: torch.Tensor, pre_k: torch.Tensor,
                     pre_v: torch.Tensor, pre_len: int, k: torch.Tensor,
                     v: torch.Tensor, *, pre_k_scale: torch.Tensor = None,
                     pre_v_scale: torch.Tensor = None) -> torch.Tensor:
    """q, k, v: [BH, S, D] (the suffix, q at positions ``pre_len + i``);
    ``pre_k``/``pre_v``: [BH, Lp, D] in ``q.dtype``, or int8 with
    ``pre_k_scale``/``pre_v_scale`` [BH, Lp, 1] f32; keys below
    ``pre_len`` (1 <= pre_len <= Lp) are visible. -> [BH, S, D] in
    ``q.dtype``."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape \
            or pre_k.dim() != 3 or pre_v.shape != pre_k.shape \
            or pre_k.shape[0] != q.shape[0] or pre_k.shape[2] != q.shape[2]:
        raise ValueError(f"prefix_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} prefix "
                         f"{tuple(pre_k.shape)} / {tuple(pre_v.shape)}")
    pre_len = int(pre_len)
    if not 1 <= pre_len <= pre_k.shape[1]:
        raise ValueError(f"prefix_attention: pre_len {pre_len} outside "
                         f"[1, {pre_k.shape[1]}]")
    scales = _check_scales("prefix_attention", pre_k, pre_v, pre_k_scale,
                           pre_v_scale)
    if all(t.device.type == "cpu" for t in (q, k, v, pre_k, pre_v, *scales)):
        return prefix_plain(q, pre_k, pre_v, pre_len, k, v,
                            pre_k_scale=pre_k_scale, pre_v_scale=pre_v_scale)
    check_cuda("prefix_attention", q, k, v)
    check_device("prefix_attention", q, pre_k, pre_v, *scales)
    if not scales:
        check_dtype("prefix_attention", q.dtype, pre_k, pre_v)
    bh, s, d = q.shape
    _check_head_dim("prefix_attention", d)
    q, k, v, pre_k, pre_v = _staged(q, k, v, pre_k, pre_v)
    scales = _staged(*scales)
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    ptrs = [x.data_ptr() for x in scales] or [None, None]
    launch("prefix_attention", _ARGTYPES_PREFIX, q.data_ptr(),
           pre_k.data_ptr(), pre_v.data_ptr(), *ptrs, pre_k.shape[1],
           pre_len, k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
           1.0 / math.sqrt(d), DTYPE_CODES[q.dtype], source="flash_attention")
    if scales:
        flash_attention_q8.launches += 1
    else:
        flash_attention.launches += 1
    return out


def _check_trainable(q, *, window, kv_len, prefix_len, int8) -> None:
    """Raise ``NotImplementedError`` for a form that needs a gradient and
    has no backward kernel: fp attention, causal or not, over T keys
    trains, at head dims 64 and 128 on the card."""
    forms = [name for name, on in (("window", window), ("kv_len",
             kv_len is not None), ("prefix_len", prefix_len),
             ("int8 K/V", int8)) if on]
    if q.device.type == "cuda" and q.shape[2] not in TRAIN_HEAD_DIMS:
        forms.append(f"head dim {q.shape[2]} on the card (the backward "
                     f"kernel takes {TRAIN_HEAD_DIMS})")
    if forms:
        raise NotImplementedError(
            f"flash_attention: no backward kernel for {', '.join(forms)}; "
            f"fp attention without window, lengths or prefix trains "
            f"({TRAIN_TODO})")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, *, causal: bool = True) -> tuple:
    """The training forward: ``flash_attention`` of q [BH, S, D] over k,
    v [BH, T, D], causal or not -> (out [BH, S, D] in ``q.dtype``, lse
    [BH, S] f32), through ``csrc/flash_attention_train.cu`` (counted
    under ``flash_attention``); CPU tensors take
    :func:`ref.flash_attention_lse_ref`."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return lse_plain(q, k, v, causal=causal)
    check_cuda("flash_attention", q, k, v)
    bh, s, d = q.shape
    if d not in TRAIN_HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: the training forward "
                                  f"takes head dims {TRAIN_HEAD_DIMS}, got "
                                  f"{d} ({TRAIN_TODO})")
    q, k, v = _staged(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if bh == 0 or s == 0:
        return out, lse
    if k.shape[1] == 0:
        raise ValueError("flash_attention: empty key sequence")
    launch("flash_attention_lse", _ARGTYPES_LSE, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, s, k.shape[1],
           d, int(causal), 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype],
           source="flash_attention_train")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True) -> tuple:
    """The gradient of ``flash_attention`` (causal or not): q, the
    forward's output ``o`` and the output's gradient ``do`` [BH, S, D],
    k, v [BH, T, D], ``lse`` [BH, S] f32 -> (dq, dk, dv) in ``q.dtype``.
    One launch of ``csrc/flash_attention_bwd.cu``'s C entry (its prep,
    dK/dV and dQ kernels) on CUDA tensors at head dims 64 and 128; CPU
    tensors take :func:`ref.flash_attention_bwd_ref`.
    ``flash_attention_bwd.launches`` counts launches."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or any(t.shape != q.shape for t in (o, do)) \
            or tuple(lse.shape) != tuple(q.shape[:2]):
        raise ValueError(f"flash_attention_bwd: bad shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} o {tuple(o.shape)} do "
                         f"{tuple(do.shape)} lse {tuple(lse.shape)}")
    if all(t.device.type == "cpu" for t in (q, k, v, o, do, lse)):
        return bwd_plain(q, k, v, o, do, lse, causal=causal)
    check_cuda("flash_attention_bwd", q, k, v, o, do)
    check_device("flash_attention_bwd", q, lse)
    check_dtype("flash_attention_bwd", torch.float32, lse)
    bh, s, d = q.shape
    t = k.shape[1]
    if d not in TRAIN_HEAD_DIMS:
        raise NotImplementedError(f"flash_attention_bwd: head dims "
                                  f"{TRAIN_HEAD_DIMS}, got {d} ({TRAIN_TODO})")
    q, k, v, o, do = _staged(q, k, v, o, do)
    lse = lse.contiguous()
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0 or s == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    launch("flash_attention_bwd", _ARGTYPES_BWD, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
           s, t, d, int(causal), 1.0 / math.sqrt(d), DTYPE_CODES[q.dtype])
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """fp attention (causal or not, S queries over T keys) with its
    hand-written gradient: the forward keeps q, k, v, the output and
    lse; the backward is one :func:`flash_attention_bwd`. Plain versions
    on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, do.to(q.dtype), lse,
                                     causal=ctx.causal), None)


flash_attention.launches = 0
flash_attention_q8.launches = 0
flash_attention_bwd.launches = 0
