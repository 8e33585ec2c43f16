"""The launch plans of the port's redesigned kernels, on the CPU.

``xfer_matmul.route`` picks the kernel and geometry of every matmul the
serving paths run (the shapes of ``chip_smoke.py``'s ``MM_CASES``),
``quant_matmul.route`` that of every INT8 matmul (``QM_CASES``), and
``paged_attention.chunk_plan`` the flash-decoding split of the fp
``paged_attention`` body. ``ref.paged_attention_split_ref`` is the plain
mirror of that split (per-chunk partials, then the merge in chunk order);
``ref.quant_matmul_split_ref`` of the int8 tensor-core routes' arithmetic
(fp32 x as three exact bf16 terms); ``ref.flash_attention_tiles_ref`` of
the tensor-core ``flash_attention``'s tile order, with P rounded before
P·V (with ``terms=True``, of the terms kernel: bf16 terms, int8 scales,
two merged states); ``ref.mlstm_chunkwise_ref(split=True)`` of the tensor-core
``mlstm_chunkwise`` (chunks of 16, C and w·k as three bf16 terms); the
split mirror with scale pools of the int8 ``paged_attention`` body. Each is held here against the JAX package's kernel (interpret mode)
or its block on inputs made from a numpy seed. The kernels themselves
run only on the card (``chip_smoke.py`` phase 3).
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
from repro.models import blocks as JB
from repro.models import recurrent as JR
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import CHUNK, chunk_plan
from repro_torch.kernels.quant_matmul import Q8_KC
from repro_torch.kernels.quant_matmul import route as q8_route
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


# ---------------------------------------------------------------------------
# quant_matmul: the int8 routes and the three-term split
# ---------------------------------------------------------------------------

_Q8_CASES = [(label, r, n, m, tr, dname)
             for label, r, n, m, tr in chip_smoke.QM_CASES
             for dname in ("float32", "bfloat16")]


@pytest.mark.parametrize("label,r,n,m,tr,dname", _Q8_CASES,
                         ids=[f"{c[0]} {c[5]}" for c in _Q8_CASES])
def test_q8_route_sends_each_int8_shape_where_the_design_says(
        label, r, n, m, tr, dname):
    """Row-major ``w_q`` at R <= 16 with rows on 16 bytes (every INT8
    projection) -> the int8 ``stream_mma``; the K-major ``embed.q.T`` ->
    ``stream_cols``; R = 2048 with a row-major ``w_q`` on 16 bytes (every
    INT8 prefill projection) -> ``wgmma``, 128 x 128 tiles; misaligned
    shapes -> ``tile``."""
    strides = _strides(n, m, tr)
    rt = q8_route(r, n, m, _DT[dname], strides, SMS)
    if r > DECODE_ROWS:
        want = "wgmma" if not tr and m % 16 == 0 and n % 8 == 0 else "tile"
    elif not tr:
        want = "stream_mma" if m % 16 == 0 else "tile"
    else:
        want = "stream_cols" if n % 64 == 0 else "tile"
    assert rt.kernel == want, (label, dname, rt)
    if rt.kernel == "stream_mma":
        assert rt.grid == (-(-m // MMA_TILE), rt.splits)
        assert math.prod(rt.grid) >= SMS
        assert rt.kc % 16 == 0 and rt.kc <= Q8_KC[_DT[dname]]
        assert (rt.splits - 1) * rt.kc < n <= rt.splits * rt.kc
    elif rt.kernel == "stream_cols":
        assert rt.splits == 1 and 1 <= rt.grid[0] <= 2 * SMS
    elif rt.kernel == "wgmma":
        assert (rt.rows, rt.cols, rt.splits) == (128, 128, 1)
        assert rt.grid == (-(-m // 128), -(-r // 128))
        assert rt.c_args == (5, 128, 128)
    else:
        assert rt.grid == (-(-m // 64), -(-r // rt.rows))
    # the serving shapes of the INT8 path, by name
    if r == chip_smoke.SLOTS and not label.startswith("ragged"):
        assert rt.kernel == ("stream_cols" if tr else "stream_mma")
    if r == chip_smoke.N_PREFILL * chip_smoke.BUCKET:
        assert rt.kernel == "wgmma"


@pytest.mark.parametrize("r,n,m,strides,aligned,want", [
    (8, 1024, 1024, (1024, 1), False, "tile"),    # w_q off 16 bytes
    (8, 1000, 1000, (1000, 1), True, "tile"),     # rows off 16 bytes
    (8, 1000, 1024, (1, 1000), True, "tile"),     # K-major, N % 64 != 0
    (16, 1024, 4096, (4096, 1), True, "stream_mma"),
    (17, 1024, 4096, (4096, 1), True, "wgmma"),   # past the decode rows
    (8, 0, 64, (64, 1), True, "tile"),            # empty contraction
    (2048, 0, 64, (64, 1), True, "tile"),         # empty contraction
    (2048, 1024, 1024, (1024, 1), False, "tile"),  # w_q off 16 bytes
    (2048, 1024, 1000, (1000, 1), True, "tile"),  # rows off 16 bytes
    (2048, 1024, 1000, (1008, 1), True, "tile"),  # M not a multiple of 16
    (2048, 1004, 1024, (1024, 1), True, "tile"),  # N not a multiple of 8
    (2048, 1024, 1024, (1, 1024), True, "tile"),  # K-major (q.T)
])
def test_q8_route_edges(r, n, m, strides, aligned, want):
    assert q8_route(r, n, m, torch.float32, strides, SMS,
                    aligned=aligned).kernel == want


def test_q8_route_takes_wgmma_only_with_x_on_16_bytes():
    assert q8_route(2048, 1024, 1024, torch.float32, (1024, 1), SMS,
                    x_aligned=False).kernel == "tile"
    assert q8_route(8, 1024, 1024, torch.float32, (1024, 1), SMS,
                    x_aligned=False).kernel == "stream_mma"


@pytest.mark.parametrize("r,n,m,x_scale", [
    (8, 512, 256, 1.0), (16, 256, 512, 1e3), (5, 256, 256, 1e-3)])
def test_quant_split_mirror_matches_jax(r, n, m, x_scale):
    """fp32 x as hi + mid + lo (bf16 each) sums back to x exactly, and
    the sum of the terms' products with the int8 weight, scaled once,
    equals JAX's ``quant_matmul`` (interpret mode) at 1e-5."""
    rng = np.random.RandomState(r + n + m)
    x = (x_scale * rng.standard_normal((r, n))).astype(np.float32)
    w_q = rng.randint(-127, 128, size=(n, m)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, size=(1, m)).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, mid, lo = ref.split_terms(xt)
    assert all(t.dtype == torch.bfloat16 for t in (hi, mid, lo))
    assert torch.equal(hi.float() + mid.float() + lo.float(), xt)
    got = ref.quant_matmul_split_ref(xt, torch.from_numpy(w_q),
                                     torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (r, m)
    want = np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(w_q),
                                       jnp.asarray(scale)))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=tol)


def test_quant_split_mirror_bf16_is_one_term():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    (term,) = ref.split_terms(xb)
    assert torch.equal(term, xb)
    w_q = torch.from_numpy(rng.randint(-127, 128, (64, 32)).astype(np.int8))
    scale = torch.full((1, 32), 0.01)
    assert torch.equal(ref.quant_matmul_split_ref(xb, w_q, scale),
                       ref.quant_matmul_ref(xb, w_q, scale))


# ---------------------------------------------------------------------------
# flash_attention: the tensor-core tile order
# ---------------------------------------------------------------------------

BF16_TOL = chip_smoke.TOL["bfloat16"]


def _within_bf16(got: np.ndarray, want: np.ndarray) -> None:
    """chip_smoke.py's bf16 check: each element within 5e-2 of its own
    magnitude plus its row's RMS."""
    rms = np.sqrt((want ** 2).mean(axis=-1, keepdims=True))
    bad = np.abs(got - want) > BF16_TOL * (np.abs(want) + rms)
    assert not bad.any(), (np.abs(got - want).max(), int(bad.sum()))


_FLASH_CASES = [(3, 77, 64, True, 0), (3, 200, 64, True, 48),
                (2, 90, 64, False, 0), (2, 300, 256, True, 100),
                (2, 130, 256, True, 0)]


@pytest.mark.parametrize("bh,s,d,causal,window", _FLASH_CASES)
@pytest.mark.parametrize("p_bf16", [False, True], ids=["p_f32", "p_bf16"])
def test_flash_tiles_mirror_matches_jax(bh, s, d, causal, window, p_bf16):
    """The kernel's tile order (blocks of 128 queries, tiles of 64 keys,
    the same tiles skipped) against JAX's ``flash_attention`` (interpret
    mode): at 2e-4 with fp32 inputs and P in fp32; with bf16 inputs and
    P rounded to bf16, at the bf16 tolerance."""
    rng = np.random.RandomState(bh * s + d)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    if p_bf16:
        jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    else:
        jargs = [jnp.asarray(a) for a in (q, k, v)]
        targs = [torch.from_numpy(a) for a in (q, k, v)]
    got = ref.flash_attention_tiles_ref(
        *targs, causal=causal, window=window,
        p_dtype=None if p_bf16 else torch.float32)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (bh, s, d)
    want = np.asarray(jops.attention(*jargs, causal=causal, window=window),
                      np.float32)
    if p_bf16:
        _within_bf16(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,d,lp,pre_len", [(37, 64, 96, 70),
                                            (50, 256, 64, 40)])
@pytest.mark.parametrize("p_bf16", [False, True], ids=["p_f32", "p_bf16"])
def test_flash_tiles_mirror_prefix_matches_jax_block(s, d, lp, pre_len,
                                                     p_bf16):
    """The shared-prefix entry's tile order (prefix tiles below
    ``pre_len``, then the causal suffix) against the JAX block's
    ``_shared_prefix_attention``; rows past ``pre_len`` hold garbage that
    must not be read."""
    b, h = 2, 2
    rng = np.random.RandomState(s + d)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    pk, pv = (rng.standard_normal((b, lp, h, d)).astype(np.float32)
              for _ in range(2))
    if p_bf16:  # bf16 values, the reference in fp32 on them
        q, k, v, pk, pv = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                           for a in (q, k, v, pk, pv))
    jcache = {"pre_k": jnp.asarray(pk), "pre_v": jnp.asarray(pv),
              "pre_len": jnp.full((b,), pre_len, jnp.int32)}
    positions = pre_len + np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want = np.asarray(JB._shared_prefix_attention(
        None, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache,
        jnp.asarray(positions), jnp.full((b,), pre_len + s, jnp.int32)))
    pk[:, pre_len:], pv[:, pre_len:] = 1e4, -1e4

    def fold(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 1, 3)
        t = t.reshape(b * h, a.shape[1], d)
        return t.to(torch.bfloat16) if p_bf16 else t

    got = ref.flash_attention_tiles_ref(
        fold(q), fold(k), fold(v), pre_k=fold(pk), pre_v=fold(pv),
        pre_len=pre_len, p_dtype=None if p_bf16 else torch.float32)
    got = got.float().reshape(b, h, s, d).permute(0, 2, 1, 3).numpy()
    if p_bf16:
        _within_bf16(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# paged_attention's int8 body: the split mirror over dequantised pools
# ---------------------------------------------------------------------------

def _q8_pools(rng, n_pages, ps, g, d):
    """int8 K/V pools and their f32 per-token scale pools [P, ps, G, 1]."""
    kq, vq = (rng.randint(-127, 128, size=(n_pages, ps, g, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(2e-3, 3e-2, size=(n_pages, ps, g, 1))
              .astype(np.float32) for _ in range(2))
    return kq, vq, ks, vs


@pytest.mark.parametrize("layout,b,h,g,d,ps,m,chunk,lengths", [
    ("grid", 3, 4, 4, 64, 96, 1, 32, [1, 50, 96]),     # one page a row
    ("grid", 2, 8, 2, 16, 64, 1, 16, [17, 64]),
    ("pool", 3, 8, 2, 64, 16, 6, 32, [1, 37, 96]),     # GQA, pages of 16
    ("pool", 2, 8, 2, 32, 16, 5, 128, [80, 16]),       # one chunk a row
])
def test_paged_split_mirror_q8_matches_jax(layout, b, h, g, d, ps, m, chunk,
                                           lengths):
    """The split mirror with scale pools (the int8 body's arithmetic)
    equals JAX's ``paged_attention(..., k_scale=, v_scale=)`` (interpret
    mode) and the plain version at 2e-4 in fp32, on the dense grid read
    through an identity table and on a pool of pages of 16 with GQA."""
    rng = np.random.RandomState(b * h + d + ps)
    n_pages = b if layout == "grid" else b * m + 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kq, vq, ks, vs = _q8_pools(rng, n_pages, ps, g, d)
    if layout == "grid":
        table = np.arange(b, dtype=np.int32)[:, None]
    else:
        table = np.stack([rng.permutation(np.arange(1, n_pages))[:m]
                          for _ in range(b)]).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    args = (q, kq, vq, table, lens)
    targs = [torch.from_numpy(a) for a in args]
    tscales = [torch.from_numpy(a) for a in (ks, vs)]
    got = ops.paged_attn_split_ref(*targs, *tscales, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, d)
    assert bool(torch.isfinite(got).all())
    want = np.asarray(jops.paged_attn(*(jnp.asarray(a) for a in args),
                                      k_scale=jnp.asarray(ks),
                                      v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), ops.paged_attn_ref(*targs, *tscales).numpy(),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("chunk", [16, 24, 128])
def test_paged_split_mirror_q8_dense_grid_equals_pool(chunk):
    """The same int8 rows and scales as a dense grid (one page of T a
    row) and as a pool of pages of 16 give bit-equal results."""
    b, h, g, d, ps, m = 3, 8, 2, 64, 16, 4
    t = ps * m
    rng = np.random.RandomState(chunk)
    kq, vq, ks, vs = (torch.from_numpy(a) for a in
                      _q8_pools(rng, b * m + 2, ps, g, d))
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    table = torch.from_numpy(np.stack(
        [rng.permutation(np.arange(1, b * m + 2))[:m] for _ in range(b)])
        .astype(np.int32))
    lens = torch.tensor([1, 30, t], dtype=torch.int32)
    tb = table.long()
    dense = [a[tb].reshape(b, t, g, a.shape[-1]) for a in (kq, vq, ks, vs)]
    ident = torch.arange(b, dtype=torch.int32)[:, None]
    pool = ops.paged_attn_split_ref(q, kq, vq, table, lens, ks, vs,
                                    chunk=chunk)
    grid = ops.paged_attn_split_ref(q, dense[0], dense[1], ident, lens,
                                    dense[2], dense[3], chunk=chunk)
    assert torch.equal(pool, grid)


# ---------------------------------------------------------------------------
# mlstm_chunkwise: the tensor-core kernel's arithmetic
# ---------------------------------------------------------------------------

_NEG = -1e30
TOL = dict(rtol=2e-4, atol=2e-4)


def _mlstm_inputs(seed, bh, s, d, tail, with_state):
    """bf16-valued q, k (scaled by 1/sqrt(D)) and v in fp32, f32 gates
    (forget pre-activations and log-forget), an identity tail of ``tail``
    steps and an optional nonzero state, from a numpy seed."""
    rng = np.random.RandomState(seed)

    def bf16_values(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float()

    q = bf16_values(rng.standard_normal((bh, s, d)))
    k = bf16_values(rng.standard_normal((bh, s, d)) / np.sqrt(d))
    v = bf16_values(rng.standard_normal((bh, s, d)))
    it = torch.from_numpy(rng.standard_normal((bh, s)).astype(np.float32))
    ft = torch.from_numpy((rng.standard_normal((bh, s)) + 2.0).astype(np.float32))
    logf = torch.nn.functional.logsigmoid(ft)
    if tail:
        it[:, s - tail:], logf[:, s - tail:] = _NEG, 0.0
    state = ()
    if with_state:
        state = tuple(torch.from_numpy((scale * rng.standard_normal(shape))
                                       .astype(np.float32))
                      for shape, scale in (((bh, d, d), 0.3), ((bh, d), 0.3),
                                           ((bh,), 1.0)))
    return q, k, v, it, ft, logf, state


@pytest.mark.parametrize("bh,s,d", [(3, 64, 32), (2, 48, 64), (2, 32, 128)])
def test_mlstm_split_mirror_matches_jax_kernel_and_oracle(bh, s, d):
    """From the zero state the tensor-core kernel's arithmetic (chunks of
    16, C and w·k as three bf16 terms) equals JAX's ``mlstm_chunkwise``
    (interpret mode, chunks of 16) and the strict per-step oracle
    ``mlstm_ref`` at 2e-4 in fp32."""
    q, k, v, it, ft, logf, _ = _mlstm_inputs(bh * s + d, bh, s, d, 0, False)
    h, C, n, m = ref.mlstm_chunkwise_ref(q, k, v, it, logf, split=True)
    assert h.dtype == torch.float32 and tuple(h.shape) == (bh, s, d)
    assert (C.shape, n.shape, m.shape) == ((bh, d, d), (bh, d), (bh,))
    jargs = [jnp.asarray(x.numpy()) for x in (q, k, v, it, ft)]
    np.testing.assert_allclose(h.numpy(), np.asarray(jops.mlstm(*jargs, bq=16)),
                               **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.mlstm_ref(*jargs)),
                               **TOL)


@pytest.mark.parametrize("bh,s,d,tail,with_state", [
    (3, 45, 32, 13, False),   # identity tail from zeros
    (3, 45, 32, 13, True),    # and from a nonzero state
    (2, 40, 64, 0, True),     # a state, S not a multiple of 16
    (2, 37, 64, 21, True),    # a tail longer than a chunk
])
def test_mlstm_split_mirror_state_matches_jax_fold(bh, s, d, tail,
                                                   with_state):
    """With an identity tail and an initial state: the split mirror's
    final (C, n, m) equals the JAX reference's ``_mlstm_suffix_state``,
    which folds the whole sequence at once; its outputs equal the
    unsplit plain version, and before the tail a run on the unpadded
    prefix, at 2e-4 in fp32."""
    q, k, v, it, ft, logf, state = _mlstm_inputs(s + d + tail, bh, s, d,
                                                 tail, with_state)
    h, C, n, m = ref.mlstm_chunkwise_ref(q, k, v, it, logf, *state,
                                         split=True)
    plain = ref.mlstm_chunkwise_ref(q, k, v, it, logf, *state)
    for got, want in zip((h, C, n, m), plain):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    keep = s - tail
    pre = ref.mlstm_chunkwise_ref(q[:, :keep], k[:, :keep], v[:, :keep],
                                  it[:, :keep], logf[:, :keep], *state,
                                  split=True)
    np.testing.assert_allclose(h[:, :keep].numpy(), pre[0].numpy(), **TOL)
    for got, want in zip((C, n, m), pre[1:]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    st = {"C": state[0].numpy()[None] if state else
          np.zeros((1, bh, d, d), np.float32),
          "n": state[1].numpy()[None] if state else
          np.zeros((1, bh, d), np.float32),
          "m": state[2].numpy()[None] if state else
          np.full((1, bh), _NEG, np.float32)}

    def bshd(x):  # [BH, S, ...] -> [1, S, BH, ...]: heads = bh
        return jnp.asarray(x.numpy()).swapaxes(0, 1)[None]

    want = JR._mlstm_suffix_state(None, {key: jnp.asarray(a)
                                         for key, a in st.items()},
                                  bshd(k), bshd(v), bshd(it), bshd(logf))
    for name, got in (("C", C), ("n", n), ("m", m)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name])[0],
                                   **TOL, err_msg=name)


def test_mlstm_split_terms_sum_to_the_state():
    """The three bf16 terms of an fp32 state sum back to it exactly, so
    the split mirror departs from the unsplit one only in the summation
    order."""
    rng = np.random.RandomState(21)
    C = torch.from_numpy((rng.standard_normal((4, 64, 64)) *
                          np.exp(rng.uniform(-8, 8, (4, 64, 64))))
                         .astype(np.float32))
    terms = ref.split_terms(C)
    assert len(terms) == 3 and all(t.dtype == torch.bfloat16 for t in terms)
    assert torch.equal(sum(t.float() for t in terms[1:]) + terms[0].float(), C)


# ---------------------------------------------------------------------------
# flash_attention at D = 64 off the bf16 fp form: the terms kernel
# ---------------------------------------------------------------------------

def _q8_kv(rng, bh, t, d):
    """int8 K/V [BH, T, D] and their f32 per-token scales [BH, T, 1]."""
    kq, vq = (rng.randint(-127, 128, size=(bh, t, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(2e-3, 3e-2, size=(bh, t, 1)).astype(np.float32)
              for _ in range(2))
    return kq, vq, ks, vs


_TERMS_CASES = [(3, 150, 150, 64, True, 0), (3, 200, 200, 64, True, 48),
                (2, 50, 77, 64, False, 0), (2, 64, 64, 64, True, 0),
                (2, 70, 70, 16, True, 0), (2, 90, 90, 32, False, 20)]


# (k/v storage, q dtype) of the terms kernel: bf16 q with fp k/v is the
# bf16 tensor-core form (test_flash_tiles_mirror_matches_jax)
_TERMS_FORMS = [("int8", "float32"), ("int8", "bfloat16"), ("fp", "float32")]


@pytest.mark.parametrize("bh,s,t,d,causal,window", _TERMS_CASES)
@pytest.mark.parametrize("kv,qdt", _TERMS_FORMS)
def test_flash_terms_mirror_matches_jax(bh, s, t, d, causal, window, kv,
                                        qdt):
    """The terms kernel's arithmetic (D = 16 and 32 zero-padded to 64 in
    the kernel, which changes no product) (q, p and fp32 k/v as bf16
    terms, int8 k/v exact with the scales on the scores and on p, two
    running states merged in order) against JAX's ``flash_attention``
    (interpret mode; ``k_scale``/``v_scale`` for int8): at 2e-4 with fp32
    q, at the bf16 tolerance with bf16 q (P rounded to bf16)."""
    rng = np.random.RandomState(bh * s + t + d)
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    tdt = _DT[qdt]
    jdt = jnp.bfloat16 if qdt == "bfloat16" else jnp.float32
    if kv == "int8":
        kq, vq, ks, vs = _q8_kv(rng, bh, t, d)
        jkv = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkv = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        jk, jv = jnp.asarray(kq), jnp.asarray(vq)
        tk, tv = torch.from_numpy(kq), torch.from_numpy(vq)
    else:
        k, v = (rng.standard_normal((bh, t, d)).astype(np.float32)
                for _ in range(2))
        jkv, tkv = {}, {}
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    from repro_torch.kernels.flash_attention import kernel_for
    assert kernel_for(tdt, d, main_q8=kv == "int8") == "flash_terms_kernel"
    got = ref.flash_attention_tiles_ref(torch.from_numpy(q).to(tdt), tk, tv,
                                        causal=causal, window=window,
                                        terms=True, **tkv)
    assert got.dtype == tdt and tuple(got.shape) == (bh, s, d)
    want = np.asarray(jops.attention(jnp.asarray(q, jdt), jk, jv,
                                     causal=causal, window=window, **jkv),
                      np.float32)
    if qdt == "bfloat16":
        _within_bf16(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s,lp,pre_len", [(37, 96, 70), (64, 256, 200),
                                          (20, 128, 64)])
@pytest.mark.parametrize("prefix,qdt", _TERMS_FORMS)
def test_flash_terms_mirror_prefix_matches_jax_block(s, lp, pre_len, prefix,
                                                     qdt):
    """The shared-prefix entry on the terms kernel (an int8 prefix with
    fp32 or bf16 q; an fp prefix with fp32 q) against the JAX block's
    ``_shared_prefix_attention`` on the dequantised prefix. Prefix rows
    past ``pre_len`` hold garbage payloads and NaN scales: never read."""
    b, h, d = 2, 2, 64
    rng = np.random.RandomState(s + lp + pre_len)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    if qdt == "bfloat16":  # bf16 values, the reference in fp32 on them
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    if prefix == "int8":
        pkq, pvq, pks, pvs = (a.reshape(b, h, lp, -1).transpose(0, 2, 1, 3)
                              for a in _q8_kv(rng, b * h, lp, d))
        pk, pv = pkq * pks, pvq * pvs   # what the JAX block gathers
    else:
        pk, pv = (rng.standard_normal((b, lp, h, d)).astype(np.float32)
                  for _ in range(2))
    jcache = {"pre_k": jnp.asarray(pk), "pre_v": jnp.asarray(pv),
              "pre_len": jnp.full((b,), pre_len, jnp.int32)}
    positions = pre_len + np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want = np.asarray(JB._shared_prefix_attention(
        None, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcache,
        jnp.asarray(positions), jnp.full((b,), pre_len + s, jnp.int32)))

    def fold(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 2, 1, 3)
        t = t.reshape(b * h, a.shape[1], a.shape[3])
        return t.to(dt) if dt is not None else t

    tdt = _DT[qdt]
    if prefix == "int8":
        pkq, pvq = pkq.copy(), pvq.copy()
        pks, pvs = pks.copy(), pvs.copy()
        pkq[:, pre_len:], pvq[:, pre_len:] = 127, -127
        pks[:, pre_len:], pvs[:, pre_len:] = np.nan, np.nan
        pre = dict(pre_k=fold(pkq), pre_v=fold(pvq), pre_k_scale=fold(pks),
                   pre_v_scale=fold(pvs))
    else:
        pk[:, pre_len:], pv[:, pre_len:] = 1e4, -1e4
        pre = dict(pre_k=fold(pk), pre_v=fold(pv))
    got = ref.flash_attention_tiles_ref(fold(q, tdt), fold(k, tdt),
                                        fold(v, tdt), pre_len=pre_len,
                                        terms=True, **pre)
    assert bool(torch.isfinite(got.float()).all())
    got = got.float().reshape(b, h, s, d).permute(0, 2, 1, 3).numpy()
    if qdt == "bfloat16":
        _within_bf16(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_terms_mirror_never_scales_past_pre_len():
    """Prefix rows at or past ``pre_len``: whatever their payload and
    scales (NaN, inf, garbage), the result is the same bits, as the
    kernel stages those rows and their scales as zeros."""
    rng = np.random.RandomState(5)
    bh, s, d, lp, pre_len = 3, 40, 64, 192, 130
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d))
                                .astype(np.float32)) for _ in range(3))
    kq, vq, ks, vs = (torch.from_numpy(a) for a in _q8_kv(rng, bh, lp, d))
    clean = ref.flash_attention_tiles_ref(
        q, k, v, pre_k=kq, pre_v=vq, pre_k_scale=ks, pre_v_scale=vs,
        pre_len=pre_len, terms=True)
    for bad in (float("nan"), float("inf"), 1e30):
        kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
        kq2[:, pre_len:], vq2[:, pre_len:] = -128, 127
        ks2[:, pre_len:], vs2[:, pre_len:] = bad, bad
        got = ref.flash_attention_tiles_ref(
            q, k, v, pre_k=kq2, pre_v=vq2, pre_k_scale=ks2, pre_v_scale=vs2,
            pre_len=pre_len, terms=True)
        assert torch.equal(got, clean), bad


def _flash_calls():
    """(q dtype, head dim, int8 prefix, int8 body) of every flash case of
    ``chip_smoke.py``."""
    calls = set()
    for _, _, _, d, _, _, dnames, _, _ in chip_smoke.FA_CASES:
        calls |= {(_DT[n], d, False, False) for n in dnames}
    for _, _, _, _, d in chip_smoke.FA_KV_CASES:
        calls |= {(dt, d, False, False) for dt in _DT.values()}
    for _, _, _, _, d, _, _, _ in chip_smoke.FQ8_CASES:
        calls |= {(dt, d, False, True) for dt in _DT.values()}
    for _, _, _, d, _, _, _ in chip_smoke.PREFIX_CASES:
        calls |= {(dt, d, q8, False) for dt in _DT.values()
                  for q8 in (False, True)}
    return sorted(calls, key=str)


@pytest.mark.parametrize("dt,d,prefix_q8,main_q8", _flash_calls(),
                         ids=lambda x: str(x))
def test_flash_route_sends_d64_fp32_and_int8_to_the_terms_kernel(
        dt, d, prefix_q8, main_q8):
    """At D <= 64 every fp32-q call and every int8 form (the body and the
    int8-prefix entry, either q dtype) takes the tensor-core terms kernel;
    bf16 with fp k/v takes ``flash_tc_kernel`` at every head dim; the
    CUDA-core row-split kernel keeps the rest (D = 128, 256). chip_smoke
    names the same instance."""
    from repro_torch.kernels.flash_attention import kernel_for
    kern = kernel_for(dt, d, prefix_q8, main_q8)
    if dt == torch.bfloat16 and not (prefix_q8 or main_q8):
        assert kern == "flash_tc_kernel"
    elif d <= 64:
        assert kern == "flash_terms_kernel"
    else:
        assert kern == "flash_split_kernel"
    readable, mangled = chip_smoke.flash_instance(dt, d, prefix_q8, main_q8)
    assert readable.startswith(kern + "<") and mangled.startswith(kern + "I")
    assert any(k in mangled for k in chip_smoke.NO_SPILL)


# ---------------------------------------------------------------------------
# rglru_scan: the launch plan
# ---------------------------------------------------------------------------

_RG_SHAPES = [(8, 2048, 2560), (1, 2048, 2560), (2, 2048, 2560),
              (3, 37, 2560), (2, 37, 1001), (4, 10, 24)]


@pytest.mark.parametrize("b,s,w", _RG_SHAPES)
@pytest.mark.parametrize("esz", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["on16", "off16"])
def test_rglru_plan_covers_every_channel_once(b, s, w, esz, aligned):
    """The grid's channel tiles partition [0, W) and its rows the batch:
    every (b, w) channel is walked by exactly one thread. The ring route
    needs a row of a and b on 16 bytes; its tile copies 16 bytes at a
    time, so ``cw`` elements are a whole number of copies."""
    from repro_torch.kernels.rglru_scan import RING_WIDTHS, plan
    p = plan(b, w, esz, aligned, SMS)
    assert p.grid[1] == b
    walked = np.zeros(w, np.int64)
    for i in range(p.grid[0]):
        walked[i * p.cw:min(w, (i + 1) * p.cw)] += 1
    assert (walked == 1).all()
    if aligned and (w * esz) % 16 == 0:
        assert p.kernel == "ring" and p.cw in RING_WIDTHS
        assert (p.cw * esz) % 16 == 0
    else:
        assert p.kernel == "rows"


@pytest.mark.parametrize("b,cw", [(1, 8), (2, 16), (3, 16), (4, 32),
                                  (8, 32)])
@pytest.mark.parametrize("esz", [4, 2], ids=["fp32", "bf16"])
def test_rglru_plan_fills_the_card(b, cw, esz):
    """At recurrentgemma-2b's width the ring route gives two blocks per
    SM, down to one batch row, with the widest tile that does (32
    channels, 128-byte rows of fp32 a step, from 4 rows up)."""
    from repro_torch.kernels.rglru_scan import plan
    p = plan(b, chip_smoke.H_WIDTH, esz, True, SMS)
    assert p.kernel == "ring" and p.grid[0] * p.grid[1] >= 2 * SMS
    assert p.cw == cw


# ---------------------------------------------------------------------------
# flash_attention_bwd: the bf16 kernels' launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,d", [(128, 512, 64), (64, 512, 128),
                                    (6, 77, 64), (5, 100, 128), (3, 2, 64),
                                    (2, 129, 128)])
def test_bwd_plan_covers_every_visible_pair_once(bh, s, d):
    """``bwd_plan``: persistent blocks, one an SM and at most one an item,
    each taking every item once between them (the order turning each
    round), 384 threads (two consumer warpgroups and a producer), a ring
    of 4 tiles of 64 rows, two own buffers at D = 64; the items with the
    most tiles first; each dkdv item visits the query tiles from its
    first key's on, each dq item the key tiles up to its last query, so
    that every causal (key, query) pair below S is in exactly one dkdv
    and one dq visit; both kernels' shared memory fits a block."""
    from repro_torch.kernels.flash_attention import bwd_plan
    p = bwd_plan(bh, s, d, SMS)
    blocks = -(-s // 128)
    assert p["items"] == bh * blocks
    assert p["grid"] == (min(bh * blocks, SMS),)
    assert sorted(i for b in p["block_items"] for i in b) == \
        list(range(p["items"]))
    bufs = 2 if d == 64 else 1
    assert (p["threads"], p["own"], p["tile"], p["stages"],
            p["own_bufs"]) == (384, 128, 64, 4, bufs)
    ring = 1024 + bufs * 2 * 128 * d * 2 + 4 * 2 * 64 * d * 2
    assert p["dq_smem"] == ring + 8 * (8 + 2 * bufs)
    assert p["dkdv_smem"] == ring + 4 * 2 * 64 * 4 + 8 * (8 + 2 * bufs)
    assert max(p["dkdv_smem"], p["dq_smem"]) <= 232448
    assert p["dkdv_tiles"] == sorted(p["dkdv_tiles"], reverse=True)
    assert p["dq_tiles"] == sorted(p["dq_tiles"], reverse=True)
    tiles = -(-s // 64)
    seen_kv = np.zeros((bh, s, s), int)
    seen_q = np.zeros((bh, s, s), int)
    for i, n in enumerate(p["dkdv_tiles"]):  # keys of block i // bh
        h, k0 = i % bh, i // bh * 128
        for t in range(tiles - n, tiles):
            seen_kv[h, 64 * t:64 * t + 64, k0:k0 + 128] += 1
    for i, n in enumerate(p["dq_tiles"]):  # queries of block i // bh from the end
        h, q0 = i % bh, (blocks - 1 - i // bh) * 128
        seen_q[h, q0:q0 + 128, :64 * n] += 1
    causal = np.broadcast_to(np.tril(np.ones((s, s), int)), (bh, s, s))
    assert (seen_kv[causal == 1] == 1).all()
    assert (seen_q[causal == 1] == 1).all()
