"""The port's MoE family (``models/moe.py``; deepseek-moe-16b and
llama4-maverick-400b-a17b, ``.reduced()``) against the JAX package on
the same weights (carried over by ``repro_torch.bridge``), fp32 on the
CPU, at 2e-4 (the tests/test_kernels.py fp32 tolerance).

* ``moe.moe_apply`` against ``_moe_apply_dense`` at capacity factors
  8.0 (the reduced configs' dropless one), 1.0 and 0.5 (assignments
  dropped), at token counts that give one slot per expert and more;
* a router with tied columns: the port's top k (a stable descending
  sort) in ``jax.lax.top_k``'s order, lowest expert first;
* the expert FFN through ``ref.expert_matmul_ref`` (the plain version of
  ``xfer_matmul_experts``) against ``_expert_ffn``, gated and relu2;
* ``LM.forward``'s hidden states and logits against the JAX ``forward``;
* greedy and top-k streams against the JAX ``ServingEngine`` on the
  slot grid and the page pool (pages of 4), prompts pinned to bucket ==
  ``max_len`` as ``repro.testing.serving_equiv`` pins them for the MoE
  family (expert capacity scales with the prefill's token count), at the
  same lookahead, at the reduced capacity factor and at a dropping one;
* the refusals: INT8 (ROADMAP A16) and speculative decoding raise, and
  the pool keeps no prefix registry (``prefix_hit_rate`` 0 on prompts
  that share a prefix).
"""
import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.models import registry as JREG
from repro.serving import sampler as JS
from repro.serving.config import PagingConfig as JPagingConfig
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import _prompts
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import moe as M
from repro_torch.quant import INT8_SERVE
from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                 ServeConfig, ServingEngine, SpecConfig)

TOL = dict(rtol=2e-4, atol=2e-4)
DEEPSEEK, LLAMA4 = "deepseek-moe-16b", "llama4-maverick-400b-a17b"
SLOTS, MAX_LEN, MAX_NEW, PS, SEED = 3, 32, 6, 4, 0
TOP_K = SamplingParams("top_k", 0.8, 5)


def _liven(tree: dict, seed: int) -> dict:
    """Seeded norms and 8x output projections on every block, so that
    greedy streams do not repeat one token."""
    rng = np.random.RandomState(seed)

    def block(b):
        b = dict(b)
        for k in ("ln1", "ln2"):
            b[k] = (0.5 * rng.standard_normal(b[k].shape)).astype(np.float32)
        b["wo"] = b["wo"] * 8.0
        for k in ("mlp", "moe", "shared"):
            if k in b:
                b[k] = dict(b[k], w_down=b[k]["w_down"] * 8.0)
        return b

    return {k: ({n: block(v) for n, v in t.items()} if k == "body" else
                block(t) if k.startswith("prefix") else t)
            for k, t in tree.items()}


_TREES = {}
# the reference's dense MoE, compiled once per shape (its eager ops would
# each compile on their own)
_jax_moe = jax.jit(JB._moe_apply_dense, static_argnums=(0,),
                   static_argnames=("capacity_factor",))


def _pair(arch_id, cf=None):
    """(JAX arch, JAX params, port arch, tree) of a reduced MoE config,
    at capacity factor ``cf`` (default: the reduced config's 8.0)."""
    if arch_id not in _TREES:
        arch_j = jax_get_arch(arch_id).reduced()
        init = jax.jit(JREG.init_params, static_argnums=(0, 2))
        _TREES[arch_id] = _liven(jax.tree.map(np.asarray, init(
            arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
    arch_j, arch = jax_get_arch(arch_id).reduced(), get_arch(arch_id).reduced()
    if cf is not None:
        arch_j = dataclasses.replace(arch_j, moe_capacity_factor=cf)
        arch = dataclasses.replace(arch, moe_capacity_factor=cf)
    tree = _TREES[arch_id]
    return arch_j, jax.tree.map(jnp.asarray, tree), arch, tree


def _moe_block(arch_id):
    """The first MoE block: (JAX subtree, port layer)."""
    arch_j, params, arch, tree = _pair(arch_id)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    p = jax.tree.map(lambda a: a[0], params["body"]["b0_attn"])
    return arch_j, p, arch, model.layers[arch.first_dense_layers]


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


@pytest.mark.parametrize("arch_id", [DEEPSEEK, LLAMA4])
@pytest.mark.parametrize("cf,b,s", [(8.0, 1, 1), (8.0, 2, 12), (1.0, 1, 2),
                                    (1.0, 3, 10), (0.5, 2, 2), (0.5, 2, 16)])
def test_moe_apply_matches_jax(arch_id, cf, b, s):
    arch_j, p, arch, layer = _moe_block(arch_id)
    arch = dataclasses.replace(arch, moe_capacity_factor=cf)
    rng = np.random.RandomState(int(cf * 10) + b * 100 + s)
    h = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
    want = _jax_moe(arch_j, p, jnp.asarray(h), capacity_factor=cf)
    got = M.moe_apply(arch, layer, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cap = M.capacity(arch, b * s)
    assert cap == max(int(math.ceil(b * s * arch.top_k / arch.num_experts * cf)), 1)
    assert (cap == 1) == (b * s * arch.top_k * cf <= arch.num_experts)
    _, idx = M.route(arch, torch.from_numpy(h).reshape(b * s, -1), layer.router)
    _, _, keep = M.dispatch(arch, idx, cap)
    if cf == 8.0:
        assert bool(keep.all())  # dropless
    if cf == 0.5 and s > 2:
        assert not bool(keep.all())  # some assignments dropped


@pytest.mark.parametrize("zero_router", [False, True])
def test_tied_router_keeps_jax_top_k_order(zero_router):
    """Columns 1, 3, 5 of the router copy 0, 2, 4 (and a zero router ties
    all eight): tied probabilities, whose top k must come in
    ``jax.lax.top_k``'s order (lowest expert first)."""
    arch_j, p, arch, layer = _moe_block(DEEPSEEK)
    router = np.asarray(p["router"]).copy()
    router[:, 1::2] = router[:, 0::2]
    if zero_router:
        router[:] = 0.0
    p = dict(p, router=jnp.asarray(router))
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(router))
    rng = np.random.RandomState(3)
    h = rng.standard_normal((2, 9, arch.d_model)).astype(np.float32)
    logits = (jnp.asarray(h).reshape(18, -1) @ p["router"]).astype(jnp.float32)
    want_vals, want_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                        arch.top_k)
    gates, idx = M.route(arch, torch.from_numpy(h).reshape(18, -1),
                         layer.router)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    if zero_router:
        assert (idx.numpy() == np.arange(arch.top_k)).all()
    else:  # the top two are a tied pair, the lower expert first
        assert (idx[:, 1] == idx[:, 0] + 1).all() and (idx[:, 0] % 2 == 0).all()
    want_g = np.asarray(want_vals / jnp.maximum(want_vals.sum(-1, keepdims=True),
                                                1e-9))
    np.testing.assert_allclose(gates.numpy(), want_g, **TOL)
    for cf in (8.0, 1.0):
        want = _jax_moe(arch_j, p, jnp.asarray(h), capacity_factor=cf)
        got = M.moe_apply(dataclasses.replace(arch, moe_capacity_factor=cf),
                          layer, torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mlp", ["swiglu", "relu2"])
def test_expert_ffn_plain_version_matches_jax(mlp):
    arch_j = dataclasses.replace(jax_get_arch(DEEPSEEK).reduced(), mlp=mlp)
    arch = dataclasses.replace(get_arch(DEEPSEEK).reduced(), mlp=mlp)
    params = JREG.init_params(arch_j, jax.random.PRNGKey(5), jnp.float32)
    moe_p = jax.tree.map(lambda a: a[0], params["body"]["b0_attn"]["moe"])
    assert ("w_gate" in moe_p) == (mlp == "swiglu")
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                   device="cpu")
    rng = np.random.RandomState(4)
    buf = rng.standard_normal((arch.num_experts, 5, arch.d_model)).astype(np.float32)
    want = JB._expert_ffn(arch_j, moe_p, jnp.asarray(buf))
    got = M.expert_ffn(arch, model.layers[1].moe, torch.from_numpy(buf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w = np.array(moe_p["w_up"])
    np.testing.assert_allclose(
        ops.expert_matmul_ref(torch.from_numpy(buf), torch.from_numpy(w)).numpy(),
        np.asarray(jnp.einsum("ecd,edf->ecf", buf, w)), **TOL)
    # the wrapper on CPU tensors is its plain version, bf16 rounded once
    xb = torch.from_numpy(buf).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    assert torch.equal(ops.expert_matmul(xb, wb), ops.expert_matmul_ref(xb, wb))
    with pytest.raises(ValueError, match="do not chain"):
        ops.expert_matmul(xb, wb[:, :3])


@pytest.mark.parametrize("arch_id", [DEEPSEEK, LLAMA4])
def test_forward_hidden_and_logits_match_jax(arch_id):
    arch_j, params, arch, tree = _pair(arch_id)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    assert len(model.layers) == arch.num_layers
    assert [layer.is_moe for layer in model.layers] == \
        [i >= arch.first_dense_layers for i in range(arch.num_layers)]
    if arch_id == DEEPSEEK:  # a dense prefix layer, untied embeddings
        assert arch.first_dense_layers == 1 and not arch.tie_embeddings
        np.testing.assert_array_equal(model.layers[0].mlp.w_up.numpy(),
                                      tree["prefix0"]["mlp"]["w_up"])
        assert tuple(model.layers[1].moe.w_gate.shape) == (8, 64, 64)
        assert tuple(model.layers[1].router.shape) == (64, 8)
    else:  # no prefix, top-1, one shared expert
        assert arch.first_dense_layers == 0 and arch.top_k == 1
    rng = np.random.RandomState(6)
    toks = rng.randint(1, 256, size=(3, 14)).astype(np.int32)
    hj, _ = JLM.forward(arch_j, params, jnp.asarray(toks))
    with torch.no_grad():
        ht, _ = model(torch.from_numpy(toks))
        lt = model.logits(ht)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(lt.numpy(),
                               np.asarray(JLM.logits_fn(arch_j, params, hj)),
                               **TOL)


_JAX_STREAMS = {}


def _jax_streams(arch_id, cf, paged, sampled, lookahead):
    key = (arch_id, cf, paged, sampled, lookahead)
    if key not in _JAX_STREAMS:
        arch_j, params, _, _ = _pair(arch_id, cf)
        extra = {}
        if sampled:
            extra["sampling"] = JS.SamplingParams("top_k", TOP_K.temperature,
                                                  TOP_K.top_k)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                 config=JServeConfig(
                                     slots=SLOTS, max_len=MAX_LEN,
                                     lookahead=lookahead,
                                     paging=JPagingConfig(paged=paged,
                                                          page_size=PS),
                                     **extra))
        for i, p in enumerate(_stream_prompts(arch_id)):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=2000)
        _JAX_STREAMS[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _JAX_STREAMS[key]


def _stream_prompts(arch_id):
    """SLOTS prompts of max_len/2 + 1 .. max_len - MAX_NEW tokens: every
    bucket is max_len, all admitted in one prefill group."""
    return _prompts(jax_get_arch(arch_id).reduced(), SLOTS, MAX_LEN, SEED,
                    MAX_NEW)


def _port_engine(arch_id, cf, paged, sampled, lookahead, **paging):
    _, _, arch, tree = _pair(arch_id, cf)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    return ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, lookahead=lookahead,
        sampling=TOP_K if sampled else None,
        paging=PagingConfig(paged=paged, page_size=PS, **paging)))


def _drive(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=2000)
    return {r.rid: list(r.out_tokens) for r in eng.completed}


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("paged", [False, True])
def test_greedy_streams_match_jax_engine(paged, cf, lookahead):
    from test_torch_step_graph import _diff
    prompts = _stream_prompts(DEEPSEEK)
    assert all(len(p) > MAX_LEN // 2 for p in prompts)  # bucket == max_len
    eng = _port_engine(DEEPSEEK, cf, paged, False, lookahead)
    got = _drive(eng, prompts)
    want = _jax_streams(DEEPSEEK, cf, paged, False, lookahead)
    bad = _diff(eng.model, prompts, got, want)
    assert not bad, bad
    assert all(len(t) == MAX_NEW for t in got.values())
    assert any(len(set(t)) > 2 for t in got.values()), got
    if paged:
        assert "kp" in eng.caches[0] and eng.scheduler.registry is None
    if cf == 0.5:  # a prefill group of 3 x 32 tokens drops assignments
        arch = _pair(DEEPSEEK, cf)[2]
        assert M.capacity(arch, SLOTS * MAX_LEN) * arch.num_experts < \
            SLOTS * MAX_LEN * arch.top_k


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch_id", [DEEPSEEK, LLAMA4])
def test_top_k_streams_match_jax_engine(arch_id, paged):
    from test_torch_sampling import stream_diff
    prompts = _stream_prompts(arch_id)
    eng = _port_engine(arch_id, None, paged, True, 1)
    got = _drive(eng, prompts)
    bad = stream_diff(eng.model, prompts, got,
                      _jax_streams(arch_id, None, paged, True, 1), TOP_K)
    assert not bad, bad


def test_refusals_and_no_prefix_reuse():
    _, _, arch, tree = _pair(DEEPSEEK)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        ServingEngine(arch, model, device="cpu", config=ServeConfig(
            slots=2, max_len=16, quant=INT8_SERVE))
    assert not model.weights_quantized  # refused before anything moved
    draft = bridge.from_jax_params(tree, arch, device="cpu")
    with pytest.raises(NotImplementedError, match="speculative decoding"):
        ServingEngine(arch, {"target": model, "draft": draft}, device="cpu",
                      config=ServeConfig(slots=2, max_len=16,
                                         sampling=SamplingParams("temperature",
                                                                 0.7),
                                         spec=SpecConfig(draft=arch, k=2)))
    # prompts sharing a 9-token prefix: the pool pages them, shares none
    eng = _port_engine(DEEPSEEK, None, True, False, 1, prefix_cache=True)
    assert eng.scheduler.registry is None
    rng = np.random.RandomState(9)
    pre = rng.randint(1, 256, size=2 * PS + 1).astype(np.int32)
    prompts = [np.concatenate([pre, rng.randint(1, 256, size=n).astype(np.int32)])
               for n in (8, 10, 12)]
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=MAX_NEW))
    eng.step()  # the first is resident before the others arrive
    for i, p in enumerate(prompts[1:], 1):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=2000)
    assert sorted(r.rid for r in eng.completed) == [0, 1, 2]
    stats = eng.prefill_stats()
    assert stats["prefix_hit_rate"] == 0.0 and stats["shared_dispatches"] == 0


def test_expert_routes():
    """``xfer_matmul_experts``'s launch plan (plain Python): deepseek's
    expert products at decode stream the weights (bf16 ``stream_mma``,
    fp32 ``stream_rows``) with no split, since 64 experts' column tiles
    already fill the card; prefill groups take ``tc`` (bf16) or
    ``tile`` (fp32), never ``wgmma`` or ``stream_cols``; one expert is
    the dense route, unchanged."""
    from repro_torch.kernels.xfer_matmul import route
    bf16, f32 = torch.bfloat16, torch.float32
    for k, n in ((2048, 1408), (1408, 2048)):
        rt = route(1, k, n, bf16, (n, 1), 132, experts=64)
        assert (rt.kernel, rt.splits) == ("stream_mma", 1)
        assert route(8, k, n, f32, (n, 1), 132, experts=64).kernel == \
            "stream_rows"
        for c in (60, 240, 480):
            assert route(c, k, n, bf16, (n, 1), 132, experts=64).kernel == "tc"
            assert route(c, k, n, f32, (n, 1), 132, experts=64).kernel == "tile"
    assert route(2048, 2048, 1408, bf16, (1408, 1), 132).kernel == "wgmma"
    assert route(2048, 2048, 1408, bf16, (1408, 1), 132, experts=1) == \
        route(2048, 2048, 1408, bf16, (1408, 1), 132)
    # few experts of a long contraction split K as the dense route does
    rt = route(9, 4096, 64, bf16, (64, 1), 132, experts=2)
    assert rt.kernel == "stream_mma" and rt.splits > 1
