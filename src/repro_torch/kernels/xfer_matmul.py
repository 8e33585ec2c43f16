"""``xfer_matmul``: the paper's <Tr, Tm, Tn>-tiled matmul core on Hopper.

Replaces the TPU kernel ``repro/kernels/xfer_matmul.py`` (``xfer_matmul``
/ ``_matmul_kernel``) with the hand-written CUDA kernels of
``csrc/xfer_matmul.cu``: ``x [R, N] @ w [N, M]`` with an fp32
accumulator, rounded to ``x.dtype`` once.

Bound on the H100: at decode (R = slots) every projection weight is read
once per step, far below the card's operations-per-byte ridge, so the
bound is the bytes of ``w``; at prefill (R = a group's tokens, 2048) bf16
is above the ridge, so the bound is the tensor cores. :func:`route` picks
one of six kernels from the shape, the dtype and ``w``'s strides:

- ``stream_mma`` (bf16, R <= 16, row-major ``w`` with rows on 4 bytes,
  every bf16 projection at decode): weight streaming with N split across
  blocks (split-K) so that every SM streams, the products on tensor
  cores (``mma.sync`` with a ``w`` tile as the A operand), so that R = 8
  rows of FMAs per weight element do not bound it; the splits are summed
  in a fixed order by the last block of each column tile, inside the same
  launch, through a per-device f32 workspace and a counter the kernel
  resets itself.
- ``stream_rows`` (R <= 16, other row-major ``w``: fp32, rows of odd
  stride): the same split-K streaming on CUDA cores, 16-byte loads where
  the rows allow.
- ``stream_cols`` (R <= 16, K-major ``w``: the tied unembedding passed
  as ``embed.T``): a warp reads whole columns with 16-byte loads and
  reduces with shuffles; no split.
- ``wgmma`` (bf16, R > 16, outputs of 2^20 elements and more, rows on 16
  bytes): warpgroup tensor-core products from 128-byte-swizzled shared
  tiles (``wgmma`` m64n128k16 or m64n256k16, ``w`` in either layout),
  a 3- or 4-stage ``cp.async`` ring with one ``wgmma`` group in flight.
- ``tc`` (bf16, R > 16, the other shapes with N a multiple of 8):
  ``mma.sync`` m16n8k16 from ``ldmatrix``, a 3-stage ``cp.async`` ring,
  block tile 128x128x64, split-K for small outputs.
- ``tile`` (everything else: fp32 at R > 16, which never runs on tensor
  cores, and misaligned shapes): the CUDA-core template.

``tr``/``tm``/``tn`` keep the planner's tiling signature; the Hopper
tiles are fixed by the route. One call is one launch and reads nothing
back to the host.

A CPU tensor takes the plain version (:func:`plain`); a CUDA tensor
launches the kernel or raises. ``xfer_matmul.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels._launch import (DTYPE_CODES, check_cuda, check_rc,
                                         current_stream, entry, scratch,
                                         sm_count)
from repro_torch.kernels.ref import expert_matmul_ref as plain_experts
from repro_torch.kernels.ref import matmul_ref as plain

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_VP, _VP, _VP, _VP)  # x, w, out, &plan


class _Plan(ctypes.Structure):
    """The C entry's ``XferPlan``: one shape's launch, built once; the
    last six fields are the expert axis of :func:`xfer_matmul_experts`
    (0 for one product)."""
    _fields_ = [("R", _I), ("N", _I), ("M", _I), ("dtype", _I),
                ("swn", _LL), ("swm", _LL), ("kernel", _I), ("p0", _I),
                ("p1", _I), ("pad", _I), ("ws", _VP), ("counters", _VP),
                ("experts", _I), ("scnt", _I), ("sx", _LL), ("sw", _LL),
                ("so", _LL), ("sws", _LL)]

#: the C entry's kernel codes
KERNEL_CODES = {"tile": 0, "stream_rows": 1, "stream_cols": 2, "tc": 3,
                "stream_mma": 4, "wgmma": 5}
DECODE_ROWS = 16        # R at or under this streams the weight
STREAM_WARPS = 8        # warps per streaming block
STREAM_ROW_LANES = 8    # stream_rows: lanes along a row (8 x 16 bytes wide)
STREAM_COLS_PER_WARP = 4
X_STAGE = 4096          # stream_rows: R x (rows of N per split) <= this
MMA_TILE = 64           # stream_mma: output columns per block
MMA_KC = 2048           # stream_mma: rows of N per split at most
SMEM_MAX = 232448       # bytes of shared memory a block may use
TC_TILE = (128, 128, 64)  # tc: rows x columns x depth
TC_SMALL = 1 << 20       # outputs under this go to tc, not wgmma
TC_SPLIT_FLOATS = 1 << 23  # tc: split-K partials at most (f32, 32 MB)


class Route(NamedTuple):
    """The kernel a call runs and its geometry: ``grid`` in blocks;
    ``rows`` the tile and tc kernels' rows per block, ``cols`` wgmma's
    columns per block; ``kc`` and ``splits`` the split-K of
    ``stream_rows``/``stream_mma`` (rows of N per split, number of splits)
    and ``tc``'s splits of its 64-row k-tiles."""
    kernel: str
    grid: tuple
    rows: int = 0
    kc: int = 0
    splits: int = 1
    cols: int = 0

    @property
    def c_args(self) -> tuple:
        """(kernel code, p0, p1) of the C entry."""
        p0 = {"tile": self.rows, "stream_rows": self.kc,
              "stream_cols": self.grid[0], "tc": 0, "stream_mma": self.kc,
              "wgmma": 0}[self.kernel]
        p1 = self.cols if self.kernel == "wgmma" else self.splits
        return KERNEL_CODES[self.kernel], p0, p1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def route(r: int, n: int, m: int, dtype: torch.dtype, strides: tuple,
          sms: int, *, aligned: bool = True, experts: int = 1) -> Route:
    """The kernel and geometry for ``x [r, n] @ w [n, m]`` in ``dtype``
    with ``w``'s element ``strides`` on a card of ``sms`` SMs.
    ``aligned``: both base pointers lie on 16 bytes (``tc`` and
    ``stream_mma`` copy rows of ``w`` that are off 16 bytes in 8-, 4- or
    2-byte pieces). Needs ``r``, ``m`` > 0. ``experts`` > 1: that many
    such products in one launch (:func:`xfer_matmul_experts`); their
    blocks count toward filling the card, and ``stream_cols`` and
    ``wgmma`` are not taken (the grid's third axis is the expert)."""
    swn, swm = strides
    vec = 16 // dtype.itemsize
    if r <= DECODE_ROWS and n > 0:
        if dtype == torch.bfloat16 and swm == 1 and swn % 2 == 0 and aligned:
            # enough splits for every SM, and as many as the card holds at
            # once (2 blocks per SM) so that no block waits for a wave
            tiles = _cdiv(m, MMA_TILE)
            blocks = tiles * experts
            splits = max(_cdiv(sms, blocks), 2 * sms // blocks)
            kc = min(MMA_KC, _cdiv(_cdiv(n, splits), 8) * 8)  # x on 16 bytes
            splits = _cdiv(n, kc)
            return Route("stream_mma", (tiles, splits), kc=kc, splits=splits)
        if swm == 1:  # 16-byte loads where the rows allow, else scalar
            tiles = _cdiv(m, STREAM_ROW_LANES * vec)
            kc = max(1, min(X_STAGE // r, n // _cdiv(sms, tiles * experts)))
            splits = _cdiv(n, kc)
            return Route("stream_rows", (tiles, splits), kc=kc, splits=splits)
        if swn == 1 and swm % vec == 0 and n % vec == 0 and aligned \
                and r * n * 4 <= SMEM_MAX and experts == 1:
            cols = STREAM_WARPS * STREAM_COLS_PER_WARP
            return Route("stream_cols", (min(_cdiv(m, cols), 2 * sms),))
    if r > DECODE_ROWS and dtype == torch.bfloat16 and aligned \
            and n % 8 == 0 and (swm == 1 or swn == 1):
        if r * m >= TC_SMALL and experts == 1 and (
                (swm == 1 and swn % 8 == 0) or (swn == 1 and swm % 8 == 0)):
            # wgmma, 128 x 256 tiles where they fill the card three times
            # over (the widest outputs), else 128 x 128
            wbn = 256 if _cdiv(m, 256) * _cdiv(r, 128) >= 3 * sms else 128
            return Route("wgmma", (_cdiv(m, wbn), _cdiv(r, 128)), cols=wbn)
        # mma.sync for small outputs and rows off 16 bytes; split-K where
        # the tiles alone leave the card's 2 blocks per SM idle and the f32
        # partials stay small, each split at least 2 k-tiles
        bm, bn, bk = TC_TILE
        grid = (_cdiv(m, bn), _cdiv(r, bm))
        tiles, kts = grid[0] * grid[1] * experts, _cdiv(n, bk)
        splits = max(1, min(2 * sms // tiles, kts // 2, 16,
                            TC_SPLIT_FLOATS // (r * m * experts)))
        splits = _cdiv(kts, _cdiv(kts, splits))  # no empty split
        return Route("tc", (*grid, splits), rows=bm, splits=splits)
    rows = 16 if r <= DECODE_ROWS else 64
    return Route("tile", (_cdiv(m, 64), _cdiv(r, rows)), rows=rows)


def _plan(name: str, x: torch.Tensor, w: torch.Tensor, aligned: bool) -> tuple:
    """Check CUDA operands once per (shapes, strides, dtypes, devices,
    alignment) and fix the launch of ``x [R, N] @ w [N, M]``, or of one
    such product per expert for ``x [E, R, N] @ w [E, N, M]`` (the card
    filled by all of them, the split-K workspace and counters one slice
    per expert): (the address of its ``_Plan``, what keeps the plan and
    the workspace alive)."""
    check_cuda(name, x, w)
    e = x.shape[0] if x.dim() == 3 else 1
    r, n = x.shape[-2:]
    m = w.shape[-1]
    strides = w.stride()[-2:]
    rt = route(r, n, m, x.dtype, strides, sm_count(x.device),
               aligned=aligned, experts=e)
    ws = counters = None
    per_ws = per_cnt = 0
    if rt.splits > 1:  # a counter per column tile (per output tile on tc)
        per_ws = rt.splits * r * m
        per_cnt = math.prod(rt.grid[:2]) if rt.kernel == "tc" else rt.grid[0]
        ws, counters = scratch("xfer_matmul", x.device, e * per_ws,
                               e * per_cnt)
    group = (e, per_cnt, r * n, n * m, r * m, per_ws) if x.dim() == 3 else ()
    plan = _Plan(r, n, m, DTYPE_CODES[x.dtype], *strides, *rt.c_args, 0,
                 ws.data_ptr() if ws is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 *group)
    return ctypes.addressof(plan), (plan, ws, counters)


_plans: dict = {}


def _launch(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (per expert where ``x`` has three axes) through one
    launch of the C entry, none for an empty output; ``x`` and ``w`` have
    been checked to chain."""
    dev = x.device
    x = x.contiguous()
    shape = (*x.shape[:-1], w.shape[-1])
    if 0 in shape:
        check_cuda(name, x, w)
        return torch.empty(shape, dtype=x.dtype, device=dev)
    xp, wp = x.data_ptr(), w.data_ptr()
    index = torch.cuda.current_device()
    key = (x.shape, w.shape, w.stride(), x.dtype, w.dtype, dev, w.device,
           index, (xp | wp) % 16 == 0)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(name, x, w, key[-1])
    out = torch.empty(shape, dtype=x.dtype, device=dev)
    fn = entry("xfer_matmul", _ARGTYPES)
    check_rc(name, fn(xp, wp, out.data_ptr(), plan[0], current_stream(index)),
             source="xfer_matmul")
    return out


def xfer_matmul(x: torch.Tensor, w: torch.Tensor, *, tr: int = 256,
                tm: int = 256, tn: int = 256) -> torch.Tensor:
    """x [R, N] @ w [N, M] -> [R, M] in ``x.dtype`` (fp32 accumulation).
    ``w`` may be any strided view (e.g. ``embed.T``)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"xfer_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    if min(tr, tm, tn) <= 0:
        raise ValueError(f"xfer_matmul: tiles must be positive, got "
                         f"{(tr, tm, tn)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return plain(x, w)
    out = _launch("xfer_matmul", x, w)
    if out.numel():  # launched
        xfer_matmul.launches += 1
    return out


xfer_matmul.launches = 0


def xfer_matmul_experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The expert products of a capacity-routed MoE layer in one launch:
    x [E, C, K] @ w [E, K, N] -> [E, C, N] in ``x.dtype`` (fp32
    accumulation), ``w`` contiguous. Block z of the grid is expert z
    (``tc``: z / splits); each expert's product runs the body that
    :func:`route` gives its shape (``stream_mma`` or ``stream_rows`` at C
    <= 16, ``tc`` or ``tile`` above) with its pointers advanced by the
    expert's offsets. Every expert is multiplied, empty or not, as the
    reference's ``einsum("ecd,edf->ecf")`` does.
    ``xfer_matmul_experts.launches`` counts launches."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"xfer_matmul_experts: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain per expert")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return plain_experts(x, w)
    if not w.is_contiguous():
        raise ValueError("xfer_matmul_experts: w must be contiguous "
                         "[E, K, N]")
    out = _launch("xfer_matmul_experts", x, w)
    if out.numel():  # launched
        xfer_matmul_experts.launches += 1
    return out


xfer_matmul_experts.launches = 0
