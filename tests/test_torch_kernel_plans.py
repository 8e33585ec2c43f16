"""The launch plans of the port's redesigned kernels, on the CPU.

``xfer_matmul.route`` picks the kernel and geometry of every matmul the
serving paths run (the shapes of ``chip_smoke.py``'s ``MM_CASES``), and
``paged_attention.chunk_plan`` the flash-decoding split of the fp
``paged_attention`` body. ``ref.paged_attention_split_ref`` is the plain
mirror of that split (per-chunk partials, then the merge in chunk order);
it is held here against the JAX package's ``paged_attention`` (interpret
mode) and its oracle on inputs made from a numpy seed. The kernels
themselves run only on the card (``chip_smoke.py`` phase 3).
"""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import CHUNK, chunk_plan
from repro_torch.kernels.xfer_matmul import (DECODE_ROWS, MMA_KC, MMA_TILE,
                                             TC_SMALL, TC_SPLIT_FLOATS,
                                             X_STAGE, route)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its module level imports no torch or jax)

SMS = 132  # H100 SXM
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CASES = [(label, r, n, m, tr, dname)
          for label, r, n, m, tr, dnames, _, _ in chip_smoke.MM_CASES
          for dname in dnames]


def _strides(n, m, transposed):
    """``w``'s element strides as chip_smoke.py makes it: a contiguous
    [n, m], or the transposed view of a contiguous [m, n] (embed.T)."""
    return (1, n) if transposed else (m, 1)


@pytest.mark.parametrize("label,r,n,m,tr,dname", _CASES,
                         ids=[f"{c[0]} {c[5]}" for c in _CASES])
def test_route_sends_each_serving_shape_where_the_design_says(
        label, r, n, m, tr, dname):
    rt = route(r, n, m, _DT[dname], _strides(n, m, tr), SMS)
    if r <= DECODE_ROWS:
        if tr:
            want = "stream_cols"
        elif dname == "bfloat16" and m % 2 == 0:  # rows on 4 bytes
            want = "stream_mma"
        else:
            want = "stream_rows"
    elif dname == "float32":
        want = "tile"
    else:  # every shape chip_smoke.py times has rows on 16 bytes
        want = "wgmma" if r * m >= TC_SMALL else "tc"
    assert rt.kernel == want, (label, dname, rt)
    if rt.kernel in ("stream_rows", "stream_mma"):
        # split-K: every SM streams, the splits cover N exactly once
        assert math.prod(rt.grid) >= SMS, rt
        assert rt.grid[1] == rt.splits
        assert (rt.splits - 1) * rt.kc < n <= rt.splits * rt.kc
        if rt.kernel == "stream_rows":
            assert 1 <= rt.kc and r * rt.kc <= X_STAGE
        else:
            assert rt.kc <= MMA_KC and rt.grid[0] == -(-m // MMA_TILE)
    elif rt.kernel == "stream_cols":
        assert rt.splits == 1 and 1 <= rt.grid[0] <= 2 * SMS
    elif rt.kernel == "wgmma":
        wide = -(-m // 256) * -(-r // 128) >= 3 * SMS
        assert rt.cols == (256 if wide else 128)
        assert rt.grid == (-(-m // rt.cols), -(-r // 128)) and rt.splits == 1
    elif rt.kernel == "tc":
        tiles = -(-m // 128) * -(-r // 128)
        kts = -(-n // 64)
        assert rt.grid == (-(-m // 128), -(-r // 128), rt.splits)
        assert -(-kts // rt.splits) * (rt.splits - 1) < kts  # none empty
        if 2 * SMS // tiles < 2 or kts < 4:
            assert rt.splits == 1
        else:  # split-K fills the card's 2 blocks per SM, small partials
            assert rt.splits > 1 and tiles * rt.splits <= 2 * SMS
            assert rt.splits * r * m <= TC_SPLIT_FLOATS


@pytest.mark.parametrize("r", [1, 8, 16, 17, 64, 2048])
def test_route_never_sends_fp32_to_tensor_cores(r):
    for strides in ((1024, 1), (1, 1024)):
        assert route(r, 1024, 1024, torch.float32, strides, SMS).kernel != "tc"


@pytest.mark.parametrize("r,n,m,strides,aligned,want", [
    (8, 1000, 1001, (1001, 1), True, "stream_rows"),  # odd row stride: scalar loads
    (8, 1024, 1024, (1024, 1), False, "stream_rows"),  # w off 16 bytes
    (8, 1000, 1001, (1, 1001), True, "tile"),         # K-major, odd stride
    (8, 1024, 4096, (1, 1024), False, "tile"),        # K-major off 16 bytes
    (8, 0, 64, (64, 1), True, "tile"),                # empty contraction
    (64, 1000, 1001, (1001, 1), True, "tc"),          # tc stages odd rows itself
    (2048, 1000, 1001, (1001, 1), True, "tc"),        # large, rows off 16 bytes
    (2048, 1024, 1024, (1024, 1), True, "wgmma"),     # large, row-major w
    (2048, 1024, 1024, (1, 1024), True, "wgmma"),     # large, K-major w
    (64, 1001, 64, (64, 1), True, "tile"),            # N not a multiple of 8
    (64, 1024, 64, (64, 1), False, "tile"),           # x off 16 bytes
    (2048, 2048, 4, (4, 1), True, "tc"),              # xlstm's w_i / w_f
])
def test_route_edges(r, n, m, strides, aligned, want):
    assert route(r, n, m, torch.bfloat16, strides, SMS,
                 aligned=aligned).kernel == want


def test_paged_chunk_plan_counts_positions_not_pages():
    """The dense slot grid (one page of 512 per row) and the pool (pages
    of 64, 8 per row) split a row the same way, so both sum the same
    values in the same order."""
    assert chunk_plan(1, 512) == chunk_plan(8, 64)
    assert chunk_plan(1, 2048) == chunk_plan(32, 64)
    chunks, size = chunk_plan(1, 512)
    assert size == CHUNK and chunks * size >= 512 > (chunks - 1) * size


def _paged_inputs(seed, b, h, g, d, ps, m, lengths=None):
    rng = np.random.RandomState(seed)
    n_pages = b * m + 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, g, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, g, d)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:m]
                      for _ in range(b)]).astype(np.int32)
    if lengths is None:
        lengths = rng.randint(1, m * ps + 1, size=b)
        lengths[-1] = m * ps
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("b,h,g,d,ps,m,chunk,lengths", [
    (2, 10, 1, 256, 8, 5, 16, None),          # MQA at D = 256, 3 chunks
    (3, 8, 2, 16, 8, 4, 8, None),             # GQA
    (3, 8, 2, 16, 8, 4, 12, [1, 5, 11]),      # every row ends in chunk 0
    (2, 4, 4, 32, 16, 3, 16, [1, 48]),        # one position; a full table
    (2, 6, 3, 64, 8, 4, 256, None),           # one chunk (the card's CHUNK)
])
def test_paged_split_mirror_matches_jax(b, h, g, d, ps, m, chunk, lengths):
    """The split mirror equals JAX's ``paged_attention`` (interpret mode)
    and its oracle at 2e-4 in fp32; chunks past a row's length merge
    with weight 0 and leave no NaN."""
    q, kp, vp, table, lens = _paged_inputs(11, b, h, g, d, ps, m, lengths)
    got = ops.paged_attn_split_ref(*(torch.from_numpy(a) for a in
                                     (q, kp, vp, table, lens)), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, d)
    assert bool(torch.isfinite(got).all())
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lens)]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref.paged_attention_ref(*jargs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.paged_attn(*jargs)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 24, 64])
def test_paged_split_mirror_dense_grid_equals_pool(chunk):
    """The same K/V rows as a dense grid (one page of T per row) and as a
    pool of pages of 8 give bit-equal results: chunks are counted in
    positions."""
    b, h, g, d, t, ps = 3, 4, 2, 16, 64, 8
    q, kp, vp, table, lens = _paged_inputs(5, b, h, g, d, ps, t // ps,
                                           [1, 30, 64])
    kt, vt = (torch.from_numpy(a) for a in (kp, vp))
    tb = torch.from_numpy(table).long()
    dense_k = kt[tb].reshape(b, t, g, d)  # row i's positions in order
    dense_v = vt[tb].reshape(b, t, g, d)
    ident = torch.arange(b, dtype=torch.int32)[:, None]
    qt, lt = torch.from_numpy(q), torch.from_numpy(lens)
    pool = ops.paged_attn_split_ref(qt, kt, vt, torch.from_numpy(table), lt,
                                    chunk=chunk)
    dense = ops.paged_attn_split_ref(qt, dense_k, dense_v, ident, lt,
                                     chunk=chunk)
    assert torch.equal(pool, dense)
