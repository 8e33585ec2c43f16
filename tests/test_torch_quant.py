"""The port's INT8 quantiser (``repro_torch.quant``) vs ``repro.quant``.

``quantize``/``dequantize``/``quantize_kv`` must give the JAX package's
int8 payloads and f32 scales bit for bit (both round half to even), on
seeded draws, all-zero tensors and values under the ``Q_EPS`` floor.
``quantize_params`` on the bridged model must give ``repro.quant.
quantize_params``'s leaves on the stacked JAX tree, leaf for leaf: one
scale per output column shared by every layer, and the per-layer norm
scales and biases quantised too (the norms and biases are set to
non-zero seeded values first; zeros would hide the stacking).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.configs import get_arch as jax_get_arch
from repro.models import registry as JREG
from repro_torch import bridge
from repro_torch import quant as Q
from repro_torch.configs import get_arch

ARCH_ID = "qwen1.5-0.5b"


def _draw(kind: str) -> np.ndarray:
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "zeros":
        return np.zeros((6, 8, 5), np.float32)
    if kind == "tiny":  # amax under the Q_EPS floor
        return (rng.standard_normal((6, 8, 5)) * 1e-14).astype(np.float32)
    if kind == "halves":  # exact .5 steps: round half to even decides
        return (rng.randint(-20, 21, (6, 8, 5)) * 0.5).astype(np.float32)
    return (rng.standard_normal((6, 8, 5)) * 3.0).astype(np.float32)


def _same(qt_port, qt_jax):
    np.testing.assert_array_equal(qt_port.q.numpy(), np.asarray(qt_jax.q))
    assert qt_port.q.dtype == torch.int8
    np.testing.assert_array_equal(qt_port.scale.numpy(),
                                  np.asarray(qt_jax.scale))


@pytest.mark.parametrize("kind", ["normal", "zeros", "tiny", "halves"])
@pytest.mark.parametrize("axis", [None, 0, (0, 1), 2])
def test_quantize_is_bit_equal_to_jax(kind, axis):
    x = _draw(kind)
    got = Q.quantize(torch.from_numpy(x), axis=axis)
    want = JQ.quantize(jnp.asarray(x), axis=axis)
    _same(got, want)
    np.testing.assert_array_equal(Q.dequantize(got).numpy(),
                                  np.asarray(JQ.dequantize(want)))
    assert Q.dequantize(got, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["normal", "zeros", "tiny"])
def test_quantize_kv_is_bit_equal_to_jax(kind):
    x = _draw(kind).reshape(2, 3, 4, 10)  # [B, T, G, D]
    got = Q.quantize_kv(torch.from_numpy(x))
    assert tuple(got.scale.shape) == (2, 3, 4, 1)
    _same(got, JQ.quantize_kv(jnp.asarray(x)))


def test_quantize_clips_to_127():
    x = torch.tensor([[1.0, -1.0, 0.5, 1.0 + 1e-7]])
    q = Q.quantize(x, axis=1).q
    assert int(q.max()) == 127 and int(q.min()) == -127


@pytest.fixture(scope="module")
def trees():
    """The reduced arch and a JAX tree (as numpy) with non-zero seeded
    norms and biases."""
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    params = jax.tree.map(np.asarray, JREG.init_params(
        arch_j, jax.random.PRNGKey(3), jnp.float32))
    rng = np.random.RandomState(4)
    body = params["body"]["b0_attn"]
    for name in ("ln1", "ln2", "bq", "bk", "bv"):
        body[name] = rng.standard_normal(body[name].shape).astype(np.float32)
    params["final_norm"] = rng.standard_normal(
        params["final_norm"].shape).astype(np.float32)
    return arch, params


def test_quantize_params_is_bit_equal_to_jax_leaf_for_leaf(trees):
    arch, params = trees
    want = JQ.quantize_params(jax.tree.map(jnp.asarray, params))
    model = Q.quantize_params(bridge.from_jax_params(params, arch,
                                                     device="cpu"))
    got = Q.named_leaves(model)
    assert not isinstance(got["final_norm"], Q.QTensor)  # 1-D, unstacked
    np.testing.assert_array_equal(got["final_norm"].detach().numpy(),
                                  params["final_norm"])
    _same(got["embed"], want["embed"])
    assert tuple(got["embed"].scale.shape) == (1, arch.d_model)
    jbody = want["body"]["b0_attn"]
    names = {"ln1", "ln2", "bq", "bk", "bv", "wq", "wk", "wv", "wo",
             "mlp.w_gate", "mlp.w_up", "mlp.w_down"}
    assert {n.split(".", 2)[2] for n in got if n.startswith("layers.")} == names
    for name in names:
        leaf = jbody
        for part in name.split("."):
            leaf = leaf[part]
        assert isinstance(leaf, JQ.QTensor), name
        # the stacked leaf's scale [1, ..., M] is one scale per column
        # for every layer
        scale = np.asarray(leaf.scale)
        assert scale.shape[0] == 1 and scale.size == leaf.q.shape[-1]
        for i in range(arch.num_layers):
            qt = got[f"layers.{i}.{name}"]
            assert isinstance(qt, Q.QTensor), name
            np.testing.assert_array_equal(qt.q.numpy(), np.asarray(leaf.q[i]))
            np.testing.assert_array_equal(qt.scale.numpy().reshape(-1),
                                          scale.reshape(-1))
            if name in {"ln1", "ln2", "bq", "bk", "bv"}:  # read in fp32
                np.testing.assert_array_equal(
                    Q.fp(qt).numpy(), np.asarray(JQ.dequantize(leaf))[i])
                assert qt.values is not None, name
    # the data makes the stacking show: a per-layer amax would differ
    ln1 = np.abs(params["body"]["b0_attn"]["ln1"])
    assert (ln1.max(axis=0) != ln1[0]).any()


def test_quantize_params_drops_fp_copies_and_refuses_twice(trees):
    arch, params = trees
    model = bridge.from_jax_params(params, arch, device="cpu")
    fp_bytes = Q.leaf_bytes(model)
    Q.quantize_params(model)
    assert [n for n, _ in model.named_parameters()] == ["final_norm"]
    assert Q.leaf_bytes(model) < fp_bytes / 3
    assert tuple(model.unembed_ones.shape) == (1, arch.vocab_size)
    with pytest.raises(ValueError, match="already"):
        Q.quantize_params(model)


def test_quant_config_matches_jax():
    assert Q.INT8_SERVE == Q.QuantConfig(weights="int8", kv="int8")
    for w in (None, "int8"):
        for kv in (None, "int8"):
            a, b = Q.QuantConfig(w, kv), JQ.QuantConfig(w, kv)
            assert (a.quant_kv, a.quant_weights) == (b.quant_kv, b.quant_weights)
    with pytest.raises(ValueError):
        Q.QuantConfig(weights="int4")
