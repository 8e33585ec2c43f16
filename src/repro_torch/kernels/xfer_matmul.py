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
from repro_torch.kernels.ref import matmul_ref as plain

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = (_VP, _VP, _VP, _VP)  # x, w, out, &plan


class _Plan(ctypes.Structure):
    """The C entry's ``XferPlan``: one shape's launch, built once."""
    _fields_ = [("R", _I), ("N", _I), ("M", _I), ("dtype", _I),
                ("swn", _LL), ("swm", _LL), ("kernel", _I), ("p0", _I),
                ("p1", _I), ("pad", _I), ("ws", _VP), ("counters", _VP)]

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
          sms: int, *, aligned: bool = True) -> Route:
    """The kernel and geometry for ``x [r, n] @ w [n, m]`` in ``dtype``
    with ``w``'s element ``strides`` on a card of ``sms`` SMs.
    ``aligned``: both base pointers lie on 16 bytes (``tc`` and
    ``stream_mma`` copy rows of ``w`` that are off 16 bytes in 8-, 4- or
    2-byte pieces). Needs ``r``, ``m`` > 0."""
    swn, swm = strides
    vec = 16 // dtype.itemsize
    if r <= DECODE_ROWS and n > 0:
        if dtype == torch.bfloat16 and swm == 1 and swn % 2 == 0 and aligned:
            # enough splits for every SM, and as many as the card holds at
            # once (2 blocks per SM) so that no block waits for a wave
            tiles = _cdiv(m, MMA_TILE)
            splits = max(_cdiv(sms, tiles), 2 * sms // tiles)
            kc = min(MMA_KC, _cdiv(_cdiv(n, splits), 8) * 8)  # x on 16 bytes
            splits = _cdiv(n, kc)
            return Route("stream_mma", (tiles, splits), kc=kc, splits=splits)
        if swm == 1:  # 16-byte loads where the rows allow, else scalar
            tiles = _cdiv(m, STREAM_ROW_LANES * vec)
            kc = max(1, min(X_STAGE // r, n // _cdiv(sms, tiles)))
            splits = _cdiv(n, kc)
            return Route("stream_rows", (tiles, splits), kc=kc, splits=splits)
        if swn == 1 and swm % vec == 0 and n % vec == 0 and aligned \
                and r * n * 4 <= SMEM_MAX:
            cols = STREAM_WARPS * STREAM_COLS_PER_WARP
            return Route("stream_cols", (min(_cdiv(m, cols), 2 * sms),))
    if r > DECODE_ROWS and dtype == torch.bfloat16 and aligned \
            and n % 8 == 0 and (swm == 1 or swn == 1):
        if r * m >= TC_SMALL and ((swm == 1 and swn % 8 == 0)
                                  or (swn == 1 and swm % 8 == 0)):
            # wgmma, 128 x 256 tiles where they fill the card three times
            # over (the widest outputs), else 128 x 128
            wbn = 256 if _cdiv(m, 256) * _cdiv(r, 128) >= 3 * sms else 128
            return Route("wgmma", (_cdiv(m, wbn), _cdiv(r, 128)), cols=wbn)
        # mma.sync for small outputs and rows off 16 bytes; split-K where
        # the tiles alone leave the card's 2 blocks per SM idle and the f32
        # partials stay small, each split at least 2 k-tiles
        bm, bn, bk = TC_TILE
        grid = (_cdiv(m, bn), _cdiv(r, bm))
        tiles, kts = grid[0] * grid[1], _cdiv(n, bk)
        splits = max(1, min(2 * sms // tiles, kts // 2, 16,
                            TC_SPLIT_FLOATS // (r * m)))
        splits = _cdiv(kts, _cdiv(kts, splits))  # no empty split
        return Route("tc", (*grid, splits), rows=bm, splits=splits)
    rows = 16 if r <= DECODE_ROWS else 64
    return Route("tile", (_cdiv(m, 64), _cdiv(r, rows)), rows=rows)


def _plan(x: torch.Tensor, w: torch.Tensor, aligned: bool) -> tuple:
    """Check CUDA operands once per (shapes, strides, dtypes, devices,
    alignment) and fix the launch: (rows, columns, the address of its
    ``_Plan``, what keeps the plan and the workspace alive)."""
    check_cuda("xfer_matmul", x, w)
    r, n = x.shape
    m = w.shape[1]
    rt = route(r, n, m, x.dtype, w.stride(), sm_count(x.device),
               aligned=aligned)
    ws = counters = None
    if rt.splits > 1:  # a counter per column tile (per output tile on tc)
        ws, counters = scratch("xfer_matmul", x.device, rt.splits * r * m,
                               math.prod(rt.grid[:2]) if rt.kernel == "tc"
                               else rt.grid[0])
    plan = _Plan(r, n, m, DTYPE_CODES[x.dtype], w.stride(0), w.stride(1),
                 *rt.c_args, 0, ws.data_ptr() if ws is not None else None,
                 counters.data_ptr() if counters is not None else None)
    return r, m, ctypes.addressof(plan), (plan, ws, counters)


_plans: dict = {}


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
    dev = x.device
    if dev.type == "cpu" and w.device.type == "cpu":
        return plain(x, w)
    x = x.contiguous()
    if x.shape[0] == 0 or w.shape[1] == 0:
        check_cuda("xfer_matmul", x, w)
        return torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                           device=dev)
    xp, wp = x.data_ptr(), w.data_ptr()
    index = torch.cuda.current_device()
    key = (x.shape, w.shape, w.stride(), x.dtype, w.dtype, dev, w.device,
           index, (xp | wp) % 16 == 0)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _plan(x, w, key[-1])
    r, m, addr, _ = plan
    out = torch.empty((r, m), dtype=x.dtype, device=dev)
    fn = entry("xfer_matmul", _ARGTYPES)
    check_rc("xfer_matmul", fn(xp, wp, out.data_ptr(), addr,
                               current_stream(index)))
    xfer_matmul.launches += 1
    return out


xfer_matmul.launches = 0
