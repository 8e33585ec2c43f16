"""Plain versions of the port's kernels vs the JAX package's oracles and
its Pallas kernels (interpret mode), on inputs made from a numpy seed.

On CPU tensors every ``repro_torch.kernels.ops`` entry runs its plain
version and no kernel launches. Shapes are drawn from the sweeps of
tests/test_kernels.py, at its tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import quant as Q
from repro_torch.kernels import ops

_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array (both round fp32 to
    bf16 to nearest even)."""
    return (jnp.asarray(x).astype(_JDT[dtype]),
            torch.from_numpy(x).to(_TDT[dtype]))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    counts = ops.launch_counts()
    assert set(counts) == {"xfer_matmul", "flash_attention", "paged_attention",
                           "paged_attention_q8", "quant_matmul", "rglru_scan",
                           "mlstm_chunkwise"}
    assert not any(counts.values()), counts


@pytest.mark.parametrize("r,n,m,tiles", [
    (256, 256, 256, (128, 128, 128)),
    (128, 128, 512, (64, 64, 256)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_jax(r, n, m, tiles, dtype):
    rng = np.random.RandomState(0)
    xj, xt = _pair(rng.standard_normal((r, n)).astype(np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((n, m)).astype(np.float32), dtype)
    tr, tn, tm = tiles
    got = ops.matmul(xt, wt, tr=tr, tn=tn, tm=tm)
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (r, m)
    np.testing.assert_allclose(_np(got), _np(jref.matmul_ref(xj, wj)),
                               **_TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(jops.matmul(xj, wj, tr=tr, tn=tn, tm=tm)), **_TOL[dtype])


def test_matmul_takes_strided_weight_view():
    """The tied unembedding passes ``embed.T``; the plain version (like
    the kernel) takes the strided view as it is."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    embed = torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))
    np.testing.assert_allclose(ops.matmul(x, embed.T).numpy(),
                               (x @ embed.T.contiguous()).numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("r,n,m,tiles", [
    (256, 256, 256, (128, 128, 128)),
    (128, 128, 512, (64, 64, 256)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_plain_matches_jax(r, n, m, tiles, dtype):
    """fp x @ int8 w with a per-column scale: the dequantise-then-matmul
    oracle and the interpret-mode Pallas kernel, which scales at flush
    (the tiles are the Pallas kernel's; the port picks its own)."""
    rng = np.random.RandomState(5)
    xj, xt = _pair(rng.standard_normal((r, n)).astype(np.float32), dtype)
    w = rng.standard_normal((n, m)).astype(np.float32)
    qt = Q.quantize(torch.from_numpy(w), axis=0)
    qj = JQ.quantize(jnp.asarray(w), axis=0)
    tr, tn, tm = tiles
    got = ops.int8_matmul(xt, qt.q, qt.scale)
    assert got.dtype == _TDT[dtype] and tuple(got.shape) == (r, m)
    np.testing.assert_allclose(
        _np(got), _np(jref.quant_matmul_ref(xj, qj.q, qj.scale)), **_TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(jops.int8_matmul(xj, qj.q, qj.scale, tr=tr, tn=tn, tm=tm)),
        **_TOL[dtype])


def test_quant_matmul_takes_strided_weight_view():
    """The tied INT8 unembedding passes ``embed.q.T`` with a unit scale
    and the embedding's column scale folded into x."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    embed = Q.quantize(torch.from_numpy(
        rng.standard_normal((40, 16)).astype(np.float32)), axis=0)
    got = ops.int8_matmul(x * embed.scale, embed.q.T, torch.ones(1, 40))
    want = x @ Q.dequantize(embed).T
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,t,d,blocks,window", [
    (256, 256, 64, (128, 128), 0),
    (256, 256, 64, (64, 64), 64),
    (64, 256, 64, (64, 128), 0),  # cross/short-query
    (96, 96, 256, (32, 32), 40),  # recurrentgemma-2b's head dim, windowed
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(s, t, d, blocks, window, dtype):
    rng = np.random.RandomState(2)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal((3, n, d)).astype(np.float32), dtype)
        for n in (s, t, t))
    causal = s == t
    got = ops.attention(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(
        _np(got), _np(jref.flash_attention_ref(qj, kj, vj, causal=causal,
                                               window=window)), **_TOL[dtype])
    np.testing.assert_allclose(
        _np(got), _np(jops.attention(qj, kj, vj, causal=causal, window=window,
                                     bq=blocks[0], bk=blocks[1])),
        **_TOL[dtype])


@pytest.mark.parametrize("b,h,g,d,ps,m", [(3, 8, 2, 16, 8, 4),
                                          (1, 6, 1, 64, 8, 3),
                                          (2, 10, 1, 256, 8, 3)])  # MQA, D 256
def test_paged_attention_plain_matches_jax(b, h, g, d, ps, m):
    """GQA head grouping, partial frontier pages and permuted tables."""
    rng = np.random.RandomState(3)
    n_pages = b * m + 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, g, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, g, d)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:m]
                      for _ in range(b)]).astype(np.int32)
    lengths = rng.randint(1, m * ps + 1, size=b).astype(np.int32)
    lengths[-1] = m * ps
    got = ops.paged_attn(*(torch.from_numpy(a) for a in
                           (q, kp, vp, table, lengths)))
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    np.testing.assert_allclose(got.numpy(), _np(jref.paged_attention_ref(*jargs)),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), _np(jops.paged_attn(*jargs)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,h,g,d,ps,m", [(3, 8, 2, 16, 8, 4),
                                          (2, 4, 4, 32, 16, 2)])
def test_paged_attention_int8_plain_matches_jax(b, h, g, d, ps, m):
    """int8 page pools with [P, ps, G, 1] scale pools through the same
    table: the JAX oracle and the interpret-mode ``_paged_kernel_q8``."""
    rng = np.random.RandomState(7)
    n_pages = b * m + 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kv = [rng.standard_normal((n_pages, ps, g, d)).astype(np.float32)
          for _ in range(2)]
    (kq, ks), (vq, vs) = ((t.q.numpy(), t.scale.numpy()) for t in
                          (Q.quantize_kv(torch.from_numpy(a)) for a in kv))
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:m]
                      for _ in range(b)]).astype(np.int32)
    lengths = rng.randint(1, m * ps + 1, size=b).astype(np.int32)
    lengths[-1] = m * ps
    t = [torch.from_numpy(a) for a in (q, kq, vq, table, lengths, ks, vs)]
    got = ops.paged_attn(*t[:5], k_scale=t[5], v_scale=t[6])
    jargs = [jnp.asarray(a) for a in (q, kq, vq, table, lengths)]
    jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
    np.testing.assert_allclose(
        got.numpy(), _np(jref.paged_attention_ref(*jargs, jks, jvs)),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), _np(jops.paged_attn(*jargs, k_scale=jks, v_scale=jvs)),
        rtol=2e-4, atol=2e-4)


def test_paged_attention_rejects_lengths_outside_the_table():
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(2, 8, 4, 16)
    table = torch.arange(2, dtype=torch.int32)[:, None]
    for bad in ([0, 3], [3, 9]):
        with pytest.raises(ValueError, match="lengths"):
            ops.paged_attn(q, pool, pool, table,
                           torch.tensor(bad, dtype=torch.int32))


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError):
        ops.matmul(torch.zeros(2, 3), torch.zeros(4, 5))
    with pytest.raises(ValueError):
        ops.matmul(torch.zeros(2, 3), torch.zeros(3, 5), tr=0)
    with pytest.raises(ValueError):
        ops.attention(torch.zeros(2, 4, 16), torch.zeros(2, 4, 8),
                      torch.zeros(2, 4, 8))
    w_q = torch.zeros(3, 5, dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.int8_matmul(torch.zeros(2, 3), w_q, torch.ones(1, 4))
    with pytest.raises(TypeError):
        ops.int8_matmul(torch.zeros(2, 3), w_q.float(), torch.ones(1, 5))
    q = torch.zeros(2, 4, 16)
    pool = torch.zeros(2, 8, 4, 16, dtype=torch.int8)
    scale = torch.ones(2, 8, 4, 1)
    table = torch.arange(2, dtype=torch.int32)[:, None]
    lens = torch.tensor([1, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        ops.paged_attn(q, pool, pool, table, lens, k_scale=scale)
    with pytest.raises(ValueError, match="scale pools"):
        ops.paged_attn(q, pool, pool, table, lens, k_scale=scale[:, :4],
                       v_scale=scale[:, :4])
    with pytest.raises(TypeError):
        ops.paged_attn(q, pool.float(), pool.float(), table, lens,
                       k_scale=scale, v_scale=scale)
