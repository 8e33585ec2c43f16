"""``quant_matmul``: fp activations times int8 weights, per-column scale.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py``
(``quant_matmul`` / ``_quant_matmul_kernel``) with the hand-written CUDA
kernels behind ``quant_matmul_launch`` of ``csrc/xfer_matmul.cu``:
``x [R, N]`` (fp32 or bf16) ``@ w_q [N, M]`` (int8) with an fp32
accumulator; ``scale [1, M]`` (f32) multiplies each output column once,
as the TPU kernel does at flush; the result is cast to ``x.dtype``.

Bound on the H100: on the INT8 serving path it reads every projection's
int8 weights once per decode step at R = slots, far below the card's
operations-per-byte ridge, so it is bound by the bytes of ``w_q`` — half
of what ``xfer_matmul`` reads in bf16. At prefill (R = a group's 2048
tokens) it is above the ridge, bound by the tensor cores over x's bf16
terms. :func:`route` picks one of four kernels from the shape, the dtype
and ``w_q``'s strides:

- ``stream_mma`` (R <= 16, row-major ``w_q`` with rows on 16 bytes:
  every INT8 projection at decode): ``xfer_matmul``'s split-K weight
  streaming on tensor cores over an int8 ``cp.async`` ring; the splits
  are summed in a fixed order by the last block of each column tile in
  the same launch, so two calls give bit-equal outputs.
- ``stream_ex`` (the expert axis of :func:`quant_matmul_experts` at R <=
  16, the same weights): one block per (expert, 64 columns) over the
  whole contraction, no split-K; each warp streams its k16 steps of the
  weight through a ``cp.async`` ring of its own, six deep, with no block
  barrier in the loop; only the expert's live rows of ``x`` staged,
  as they are given; fp32 ``x``'s three terms packed into the columns of
  one ``mma.sync`` B fragment where rows x terms <= 8.
- ``stream_cols`` (R <= 16, K-major ``w_q``: the tied unembedding passed
  as ``embed.q.T``, no transposed copy): q's rows read straight into
  registers as the ``mma.sync`` A operand; no split.
- ``wgmma`` (R > 16, row-major ``w_q`` with rows on 16 bytes, M % 16 ==
  0, N % 8 == 0, ``x`` and ``w_q`` on 16 bytes: every INT8 prefill
  projection): warpgroup products (``wgmma`` m64n128k16, 128 x 128
  tiles) on x's terms as shared A tiles and the int8 tile widened
  exactly to bf16 in ``xfer_matmul``'s swizzled B layout, the next
  k-tile loaded and split while the current one's products run; one
  fp32 accumulator over the terms, the scale at the store.
- ``tile`` (misaligned shapes): the CUDA-core template that
  ``xfer_matmul`` keeps for fp32, fp32 FMA with the int8 tile widened in
  shared memory; 16 rows per block when R <= 16, else 64.

On tensor cores every int8 weight is widened exactly to bf16. fp32 ``x``
(the INT8 path's activations) goes in as three bf16 terms, ``hi =
bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``, which sum
to ``x`` exactly for normal values; each term times a weight is exact in
fp32, so the result departs from the fp32 TPU kernel only in the order
of the sums (no TF32; :func:`repro_torch.kernels.ref.quant_matmul_split_ref`
is the plain mirror). bf16 ``x`` is one term.

The launch plan (route, split-K workspace and counters from
``_launch.scratch``, per device) is built once per shape and passed to
the C entry as one struct. The kernel resets its counters, so the
pointers stay valid from call to call.

:func:`quant_matmul_experts` runs the same bodies over an expert axis
(grid z), the int8 counterpart of ``xfer_matmul_experts``: the MoE
family's expert products under INT8 weights, ``x [E, C, K] @ w_q [E, K,
N]`` with one column scale for all experts (the reference quantises the
stacked expert leaf ``[L, E, K, N]`` with one scale per column over
layers, experts and rows) and ``counts`` [E] int32, each expert's live
rows: rows past them come out +0, and an expert with no live row reads
none of its weight bytes (``stream_ex`` at C <= 16, every block of it
returns at once; ``wgmma`` above, where a 128-row tile past the live rows
does). ``tile`` takes the misaligned shapes; ``stream_mma`` and
``stream_cols`` are not taken over experts. ``stream_ex`` sums each
term's products apart and the terms last, hi + mid + lo:
:func:`repro_torch.kernels.ref.quant_matmul_experts_split_ref` is its
plain mirror.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``quant_matmul.launches`` and
``quant_matmul_experts.launches`` count launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_device,
                                         check_dtype, check_float, check_rc,
                                         current_stream, entry, scratch,
                                         sm_count)
from repro_torch.kernels.ref import quant_matmul_experts_ref as plain_experts
from repro_torch.kernels.ref import quant_matmul_ref as plain
from repro_torch.kernels.xfer_matmul import (DECODE_ROWS, MMA_TILE, SMEM_MAX,
                                             STREAM_WARPS, Route, _cdiv,
                                             _Plan, check_counts)

_VP = ctypes.c_void_p
_ARGTYPES = (_VP,) * 6  # x, w_q, scale, counts, out, &plan

#: stream_mma: rows of N per split at most, by x's dtype (fp32 x is
#: staged as three bf16 terms, so its splits are shorter)
Q8_KC = {torch.float32: 1024, torch.bfloat16: 2048}
Q8_COLS_PER_WARP = 16   # stream_cols: output columns per warp
Q8_CHUNK = 64           # stream_cols: N is read in chunks of this many
Q8_WG_TILE = 128        # wgmma: rows and columns per block
EX_TILE = 64            # stream_ex: output columns per block
EX_RING = STREAM_WARPS * 6 * 16 * 80  # stream_ex: the warps' rings of w


def x_terms(dtype: torch.dtype) -> int:
    """bf16 terms the tensor-core routes stage ``x`` as."""
    return 3 if dtype == torch.float32 else 1


def ex_smem(r: int, n: int, dtype: torch.dtype) -> int:
    """``stream_ex``'s shared memory for ``x [r, n]`` in ``dtype``: the
    warps' rings of w (6 k16 steps of 16 rows x 80 bytes each) and the x
    stage (rows of n rounded up to 16, plus 8) or, over them, the warps'
    partial sums of every row and term, whichever is larger."""
    x_stage = r * (_cdiv(n, 16) * 16 + 8) * dtype.itemsize
    return max(EX_RING + x_stage,
               STREAM_WARPS * r * x_terms(dtype) * EX_TILE * 4)


@functools.lru_cache(maxsize=None)
def route(r: int, n: int, m: int, dtype: torch.dtype, strides: tuple,
          sms: int, *, aligned: bool = True, x_aligned: bool = True,
          experts: int = 0) -> Route:
    """The kernel and geometry for ``x [r, n] @ w_q [n, m]`` with ``x`` in
    ``dtype`` and ``w_q``'s element ``strides``, on a card of ``sms`` SMs.
    ``aligned``: ``w_q``'s base pointer lies on 16 bytes; ``x_aligned``:
    ``x``'s does (over experts: every expert's). Needs ``r``, ``m`` > 0.
    ``experts`` >= 1: an expert axis of that many products in one launch
    (:func:`quant_matmul_experts`): ``stream_ex`` at decode, ``wgmma``
    with the expert on grid z above, never ``stream_mma`` or
    ``stream_cols``; 0: one product."""
    swn, swm = strides
    if r <= DECODE_ROWS and n > 0 and aligned and experts:
        if swm == 1 and swn % 16 == 0 and m % 16 == 0 \
                and ex_smem(r, n, dtype) <= SMEM_MAX:
            return Route("stream_ex", (_cdiv(m, EX_TILE), 1), cols=EX_TILE)
    elif r <= DECODE_ROWS and n > 0 and aligned:
        rb = 8 if r <= 8 else 16
        if swm == 1 and swn % 16 == 0:
            # xfer_matmul's stream_mma geometry: every SM streams, and as
            # many splits as the card holds at once
            tiles = _cdiv(m, MMA_TILE)
            splits = max(_cdiv(sms, tiles), 2 * sms // tiles)
            kc = min(Q8_KC[dtype], _cdiv(_cdiv(n, splits), 16) * 16)
            splits = _cdiv(n, kc)
            return Route("stream_mma", (tiles, splits), kc=kc, splits=splits)
        if swn == 1 and swm % 16 == 0 and n % Q8_CHUNK == 0 \
                and x_terms(dtype) * rb * (n + 4) * 2 <= SMEM_MAX:
            cols = STREAM_WARPS * Q8_COLS_PER_WARP
            return Route("stream_cols", (min(_cdiv(m, cols), 2 * sms),))
    if r > DECODE_ROWS and n > 0 and swm == 1 and swn % 16 == 0 \
            and m % 16 == 0 and n % 8 == 0 and aligned and x_aligned:
        return Route("wgmma", (_cdiv(m, Q8_WG_TILE), _cdiv(r, Q8_WG_TILE)),
                     rows=Q8_WG_TILE, cols=Q8_WG_TILE)
    rows = 16 if r <= DECODE_ROWS else 64
    return Route("tile", (_cdiv(m, 64), _cdiv(r, rows)), rows=rows)


def _plan(x: torch.Tensor, w_q: torch.Tensor, aligned: bool,
          x_aligned: bool) -> tuple:
    """Fix one shape's launch of ``x [R, N] @ w_q [N, M]``, or of one
    such product per expert for ``x [E, R, N] @ w_q [E, N, M]`` (the
    split-K workspace and counters one slice per expert): (the address
    of its ``_Plan``, what keeps the plan and the workspace alive)."""
    e = x.shape[0] if x.dim() == 3 else 1
    r, n = x.shape[-2:]
    m = w_q.shape[-1]
    rt = route(r, n, m, x.dtype, w_q.stride()[-2:], sm_count(x.device),
               aligned=aligned, x_aligned=x_aligned,
               experts=e if x.dim() == 3 else 0)
    ws = counters = None
    per_ws = per_cnt = 0
    if rt.splits > 1:  # a counter per 64-column tile
        per_ws, per_cnt = rt.splits * r * m, rt.grid[0]
        ws, counters = scratch("quant_matmul", x.device, e * per_ws,
                               e * per_cnt)
    group = (e, per_cnt, r * n, n * m, r * m, per_ws) if x.dim() == 3 else ()
    plan = _Plan(r, n, m, DTYPE_CODES[x.dtype], *w_q.stride()[-2:],
                 *rt.c_args, 0, ws.data_ptr() if ws is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 *group)
    return ctypes.addressof(plan), (plan, ws, counters)


_plans: dict = {}


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [R, N] fp @ w_q [N, M] int8, times scale [1, M] f32 -> [R, M] in
    ``x.dtype``. ``w_q`` may be any strided view (e.g. ``q.T``)."""
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain")
    m = w_q.shape[1]
    if scale.numel() != m:
        raise ValueError(f"quant_matmul: scale {tuple(scale.shape)} for "
                         f"{m} columns")
    check_dtype("quant_matmul", torch.int8, w_q)
    check_dtype("quant_matmul", torch.float32, scale)
    if all(t.device.type == "cpu" for t in (x, w_q, scale)):
        return plain(x, w_q, scale)
    out = _launch("quant_matmul", x, w_q, scale)
    if out.numel():  # launched
        quant_matmul.launches += 1
    return out


def _launch(name: str, x: torch.Tensor, w_q: torch.Tensor,
            scale: torch.Tensor, counts: torch.Tensor = None) -> torch.Tensor:
    """``x @ w_q`` times the scale (per expert where ``x`` has three
    axes, ``counts`` its live rows) through one launch of the C entry,
    none for an empty output; the operands have been checked to chain."""
    x, scale = x.contiguous(), scale.contiguous()
    dev = x.device
    shape = (*x.shape[:-1], w_q.shape[-1])
    if 0 in shape:
        check_device(name, x, w_q, scale)
        check_float(name, x)
        return torch.empty(shape, dtype=x.dtype, device=dev)
    xp, wp = x.data_ptr(), w_q.data_ptr()
    # over experts every expert's x and w_q start on 16 bytes too
    x_step = x.shape[1] * x.shape[2] * x.element_size() if x.dim() == 3 \
        else 0
    w_step = w_q.shape[1] * w_q.shape[2] if w_q.dim() == 3 else 0
    index = torch.cuda.current_device()
    key = (x.shape, w_q.shape, w_q.stride(), x.dtype, dev, w_q.device,
           scale.device, index, (wp | w_step) % 16 == 0,
           (xp | x_step) % 16 == 0)
    plan = _plans.get(key)
    if plan is None:
        check_device(name, x, w_q, scale)
        check_float(name, x)
        plan = _plans[key] = _plan(x, w_q, *key[-2:])
    out = torch.empty(shape, dtype=x.dtype, device=dev)
    fn = entry("quant_matmul", _ARGTYPES, "xfer_matmul")
    cp = counts.data_ptr() if counts is not None else None
    check_rc(name, fn(xp, wp, scale.data_ptr(), cp, out.data_ptr(), plan[0],
                      current_stream(index)), "xfer_matmul")
    return out


def quant_matmul_experts(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor,
                         counts: torch.Tensor = None) -> torch.Tensor:
    """The int8 expert products of a capacity-routed MoE layer in one
    launch: x [E, C, K] fp @ w_q [E, K, N] int8 (contiguous), times
    ``scale`` (N f32 values, e.g. ``[1, 1, N]``, one for every expert)
    -> [E, C, N] in ``x.dtype`` (fp32 accumulation). ``counts`` [E]
    int32 on ``x``'s device: expert e's rows at or past ``counts[e]``
    come out +0, and an expert with no live row reads none of its
    weights; ``None``: every row live, as the reference's
    ``einsum("ecd,edf->ecf")`` on its dequantised weights.
    ``quant_matmul_experts.launches`` counts launches."""
    if x.dim() != 3 or w_q.dim() != 3 or x.shape[0] != w_q.shape[0] \
            or x.shape[2] != w_q.shape[1]:
        raise ValueError(f"quant_matmul_experts: shapes {tuple(x.shape)} @ "
                         f"{tuple(w_q.shape)} do not chain per expert")
    if scale.numel() != w_q.shape[2]:
        raise ValueError(f"quant_matmul_experts: scale {tuple(scale.shape)} "
                         f"for {w_q.shape[2]} columns")
    check_counts("quant_matmul_experts", x, counts)
    check_dtype("quant_matmul_experts", torch.int8, w_q)
    check_dtype("quant_matmul_experts", torch.float32, scale)
    if all(t.device.type == "cpu" for t in (x, w_q, scale) +
           ((counts,) if counts is not None else ())):
        return plain_experts(x, w_q, scale, counts)
    if not w_q.is_contiguous():
        raise ValueError("quant_matmul_experts: w_q must be contiguous "
                         "[E, K, N]")
    out = _launch("quant_matmul_experts", x, w_q, scale.reshape(-1), counts)
    if out.numel():  # launched
        quant_matmul_experts.launches += 1
    return out


quant_matmul.launches = 0
quant_matmul_experts.launches = 0
