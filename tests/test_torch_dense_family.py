"""The rest of the dense family in the port (yi-9b and phi3-medium-14b:
GQA at head dim 128; minitron-8b: the ungated squared-ReLU MLP,
``mlp="relu2"``), ``.reduced()``, against the JAX package on the same
weights (carried over by ``repro_torch.bridge``), fp32 on the CPU, at
2e-4 (the tests/test_kernels.py fp32 tolerance): ``LM.forward``'s hidden
states and logits, greedy streams against the JAX ``ServingEngine`` on
the slot grid, and the relu2 MLP against ``layers.mlp_apply``. Every
architecture the port registers is its JAX config field by field.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import registry as JREG
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import _prompts
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.serving import Request, ServeConfig, ServingEngine

TOL = dict(rtol=2e-4, atol=2e-4)
DENSE = ("yi-9b", "phi3-medium-14b", "minitron-8b")
SLOTS, N_REQ, MAX_LEN, MAX_NEW, SEED = 2, 5, 32, 6, 0


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_registered_config_matches_jax(arch_id):
    for reduce in (False, True):
        a, b = get_arch(arch_id), jax_get_arch(arch_id)
        if reduce:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_dense_configs_run_at_head_dim_128():
    for arch_id in DENSE:
        arch = get_arch(arch_id)
        assert arch.family == "dense" and arch.head_dim == 128
        assert arch.num_heads // arch.num_kv_heads in (4, 8)  # GQA
    assert get_arch("minitron-8b").mlp == "relu2"


_TREES = {}


def _pair(arch_id):
    if arch_id not in _TREES:
        arch_j = jax_get_arch(arch_id).reduced()
        tree = jax.tree.map(np.asarray, JREG.init_params(
            arch_j, jax.random.PRNGKey(SEED), jnp.float32))
        # seeded norms and 8x output projections: streams that do not
        # repeat one token
        rng = np.random.RandomState(SEED + 1)
        body = dict(tree["body"]["b0_attn"])
        for k in ("ln1", "ln2"):
            body[k] = (0.5 * rng.standard_normal(body[k].shape)).astype(np.float32)
        body["wo"] = body["wo"] * 8.0
        body["mlp"] = dict(body["mlp"], w_down=body["mlp"]["w_down"] * 8.0)
        _TREES[arch_id] = dict(tree, body={"b0_attn": body})
    tree = _TREES[arch_id]
    return (jax_get_arch(arch_id).reduced(), jax.tree.map(jnp.asarray, tree),
            get_arch(arch_id).reduced(), tree)


@pytest.mark.parametrize("arch_id", DENSE)
def test_forward_hidden_and_logits_match_jax(arch_id):
    arch_j, params, arch, tree = _pair(arch_id)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    if arch.mlp == "relu2":  # ungated: no w_gate in either tree
        assert "w_gate" not in tree["body"]["b0_attn"]["mlp"]
        assert not hasattr(model.layers[0].mlp, "w_gate")
    rng = np.random.RandomState(2)
    toks = rng.randint(1, 256, size=(2, 13)).astype(np.int32)
    hj, _ = JLM.forward(arch_j, params, jnp.asarray(toks))
    with torch.no_grad():
        ht, _ = model(torch.from_numpy(toks))
        lt = model.logits(ht)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(lt.numpy(),
                               np.asarray(JLM.logits_fn(arch_j, params, hj)),
                               **TOL)


def test_relu2_mlp_matches_jax():
    arch_j, params, arch, _ = _pair("minitron-8b")
    p = jax.tree.map(lambda a: a[0], params["body"]["b0_attn"]["mlp"])
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 7, arch.d_model)).astype(np.float32)
    want = JL.mlp_apply(p, jnp.asarray(x), "relu2")

    class MLP:
        w_up = torch.from_numpy(np.array(p["w_up"]))
        w_down = torch.from_numpy(np.array(p["w_down"]))

    got = L.mlp_apply(MLP, torch.from_numpy(x), "relu2")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    h = x @ np.asarray(p["w_up"])  # relu(x @ w_up)² @ w_down, no gate
    np.testing.assert_allclose(got.numpy(),
                               np.square(np.maximum(h, 0)) @ np.asarray(p["w_down"]),
                               **TOL)


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("arch_id", DENSE)
def test_greedy_streams_match_jax_engine(arch_id, lookahead):
    from test_torch_step_graph import _diff
    arch_j, params, arch, tree = _pair(arch_id)
    prompts = _prompts(arch_j, N_REQ, MAX_LEN, SEED + 1, MAX_NEW)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServingEngine(arch_j, params, dtype=jnp.float32,
                              config=JServeConfig(slots=SLOTS, max_len=MAX_LEN,
                                                  lookahead=lookahead))
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, lookahead=lookahead))
    for e, req in ((jeng, JRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            e.submit(req(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        e.run_until_drained(max_steps=2000)
    want = {r.rid: list(r.out_tokens) for r in jeng.completed}
    got = {r.rid: list(r.out_tokens) for r in eng.completed}
    bad = _diff(model, prompts, got, want)
    assert not bad, bad
    assert len(prompts) > SLOTS  # finished slots re-admit mid-stream
    assert any(len(set(t)) > 2 for t in got.values()), got
