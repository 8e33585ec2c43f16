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


#: one reduced arch per family the port serves
FAMILY_ARCHS = {"dense": ARCH_ID, "moe": "deepseek-moe-16b",
                "hybrid": "recurrentgemma-2b", "ssm": "xlstm-350m",
                "encdec": "seamless-m4t-medium", "vlm": "paligemma-3b"}
_TREES = {}


def _tree(arch_id):
    """The reduced arch and a JAX tree (as numpy) whose all-zero leaves
    (norms, biases) are seeded non-zero: zeros would hide the stacking."""
    if arch_id not in _TREES:
        arch_j = jax_get_arch(arch_id).reduced()
        init = jax.jit(JREG.init_params, static_argnums=(0, 2))
        tree = jax.tree.map(np.asarray, init(arch_j, jax.random.PRNGKey(3),
                                             jnp.float32))
        rng = np.random.RandomState(4)
        tree = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32)
            if not x.any() else x, tree)
        _TREES[arch_id] = (get_arch(arch_id).reduced(), tree)
    return _TREES[arch_id]


@pytest.fixture(scope="module")
def trees():
    return _tree(ARCH_ID)


def _jax_leaves(arch, tree):
    """Each leaf of the stacked JAX tree as ``(port name, leaf, layer
    index in its stack or None)``: ``body.b{j}_{kind}`` entry r is layer
    ``n_prefix + r * len(pattern) + j``, ``prefix{i}`` layer i,
    ``suffix{i}`` the layers after the body, ``enc_body``/``dec_body``
    entry r ``enc_layers.r``/``dec_layers.r``."""
    from repro_torch.models.lm import pattern, stack_structure
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
            return
        top, rest = path[0], ".".join(path[1:])
        if top in ("enc_body", "dec_body"):
            n = t.shape[0] if not isinstance(t, JQ.QTensor) else t.q.shape[0]
            name = "enc_layers" if top == "enc_body" else "dec_layers"
            out.extend((f"{name}.{r}.{rest}", t, r) for r in range(n))
        elif top == "body":
            prefix, repeats, _ = stack_structure(arch)
            pat = pattern(arch)
            j = int(path[1][1:].split("_")[0])
            rest = ".".join(path[2:])
            out.extend((f"layers.{len(prefix) + r * len(pat) + j}.{rest}",
                        t, r) for r in range(repeats))
        elif top.startswith("prefix"):
            out.append((f"layers.{int(top[6:])}.{rest}", t, None))
        elif top.startswith("suffix"):
            prefix, repeats, _ = stack_structure(arch)
            i = len(prefix) + repeats * len(pattern(arch)) + int(top[6:])
            out.append((f"layers.{i}.{rest}", t, None))
        else:
            out.append((".".join(path), t, None))

    walk(tree, [])
    return out


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_quantize_params_is_bit_equal_to_jax_leaf_for_leaf(family):
    """Payloads and scales of every leaf equal ``repro.quant.
    quantize_params`` on the stacked JAX tree: a stacked leaf's one
    scale per column for every layer of its stack (1-D leaves quantised
    too, read in fp32 through ``values``), a prefix or suffix layer's
    own per-channel scales with fp 1-D leaves, fp top-level norms."""
    arch, tree = _tree(FAMILY_ARCHS[family])
    want = JQ.quantize_params(jax.tree.map(jnp.asarray, tree))
    model = Q.quantize_params(bridge.from_jax_params(tree, arch,
                                                     device="cpu"))
    got = Q.named_leaves(model)
    pairs = _jax_leaves(arch, jax.tree.map(
        lambda x: JQ.QTensor(np.asarray(x.q), np.asarray(x.scale))
        if isinstance(x, JQ.QTensor) else np.asarray(x), want,
        is_leaf=lambda x: isinstance(x, JQ.QTensor)))
    assert sorted(n for n, _, _ in pairs) == sorted(got)
    kinds = set()
    for name, leaf, r in pairs:
        port = got[name]
        if not isinstance(leaf, JQ.QTensor):  # fp in the reference
            assert not isinstance(port, Q.QTensor), name
            np.testing.assert_array_equal(
                port.detach().numpy(), leaf if r is None else leaf[r])
            kinds.add("fp")
            continue
        assert isinstance(port, Q.QTensor), name
        q, scale = np.asarray(leaf.q), np.asarray(leaf.scale)
        if r is not None:  # stacked: one scale per column for every layer
            assert scale.shape[0] == 1
            q, scale = q[r], scale[0]
            kinds.add("stacked")
        else:
            kinds.add("alone")
        np.testing.assert_array_equal(port.q.numpy(), q, err_msg=name)
        assert port.q.dtype == torch.int8
        np.testing.assert_array_equal(port.scale.numpy(), scale, err_msg=name)
        if port.q.dim() == 1:  # read in fp32
            assert port.values is not None, name
        if port.values is not None:
            np.testing.assert_array_equal(
                port.values.numpy(), q.astype(np.float32) * scale)
    assert {"stacked", "fp"} <= kinds
    if family == "moe":  # the prefix layer alone, the experts stacked
        assert not Q.is_qtensor(got["layers.0.ln1"])
        assert tuple(got["layers.1.moe.w_gate"].scale.shape) == \
            (1, 1, arch.moe_d_ff)
        assert Q.is_qtensor(got["layers.1.router"])
    if family == "hybrid":  # the unstacked suffix keeps fp norms
        last = f"layers.{arch.num_layers - 1}"
        assert not Q.is_qtensor(got[f"{last}.ln1"])
        assert Q.is_qtensor(got[f"{last}.conv_w"])
        assert got[f"{last}.gate_w"].values is not None
    if family == "encdec":
        assert not Q.is_qtensor(got["enc_norm"])
        assert Q.is_qtensor(got["dec_layers.0.xwk"])
    if family == "dense":  # the data makes the stacking show
        ln1 = np.abs(tree["body"]["b0_attn"]["ln1"])
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
