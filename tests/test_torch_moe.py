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
* each expert's live rows (``moe.expert_counts``) against a host count of
  ``dispatch``'s kept assignments, and the plain expert product with
  them: equal to the full one on dispatched buffers, +0 past them;
* ``LM.forward``'s hidden states and logits against the JAX ``forward``;
* greedy and top-k streams against the JAX ``ServingEngine`` on the
  slot grid and the page pool (pages of 4), prompts pinned to bucket ==
  ``max_len`` as ``repro.testing.serving_equiv`` pins them for the MoE
  family (expert capacity scales with the prefill's token count), at the
  same lookahead, at the reduced capacity factor and at a dropping one;
* INT8 (``INT8_SERVE``): the expert leaves quantised with one column
  scale over layers and experts, the plain ``quant_matmul_experts``
  against the reference's ``einsum`` on dequantised weights with live
  rows, its launch plan, and greedy streams against the JAX quantised
  engine on the grid and the pool;
* the refusals: speculative decoding raises, and the pool keeps no
  prefix registry (``prefix_hit_rate`` 0 on prompts that share a
  prefix).
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


def _dispatched(arch, layer, h):
    """moe_apply's dispatch of ``h`` [B, S, D]: (the [E, cap, D] buffer
    of kept tokens, zero elsewhere, keep, the sorted expert ids, cap)."""
    b, s, d = h.shape
    t, e = b * s, arch.num_experts
    cap = M.capacity(arch, t)
    hf = h.reshape(t, d)
    _, idx = M.route(arch, hf, layer.router)
    order, dest, keep = M.dispatch(arch, idx, cap)
    buf = torch.zeros((e * cap + 1, d), dtype=h.dtype)
    buf[dest] = hf[order // arch.top_k]
    eid_s = torch.sort(idx.reshape(-1), stable=True).values
    return buf[:e * cap].reshape(e, cap, d), idx, keep, eid_s, cap


@pytest.mark.parametrize("cf,b,s", [(8.0, 2, 12), (1.0, 1, 2), (1.0, 3, 10),
                                    (0.5, 2, 16), (0.25, 4, 9)])
def test_expert_counts_are_the_kept_assignments(cf, b, s):
    """``expert_counts`` equals a host count of ``dispatch``'s kept
    assignments per expert, with drops (cf <= 1) and without (8.0); the
    buffer's rows at or past an expert's count are zero."""
    _, _, arch, layer = _moe_block(DEEPSEEK)
    arch = dataclasses.replace(arch, moe_capacity_factor=cf)
    rng = np.random.RandomState(int(cf * 100) + b * 10 + s)
    h = torch.from_numpy(rng.standard_normal((b, s, arch.d_model))
                         .astype(np.float32))
    buf, idx, keep, eid_s, cap = _dispatched(arch, layer, h)
    counts = M.expert_counts(arch, idx, cap)
    assert counts.dtype == torch.int32
    assert tuple(counts.shape) == (arch.num_experts,)
    want = np.zeros(arch.num_experts, np.int64)
    np.add.at(want, eid_s.numpy(), keep.numpy().astype(np.int64))
    np.testing.assert_array_equal(counts.numpy(), want)
    assert int(counts.max()) <= cap
    assert (cf == 8.0) == bool(keep.all())
    rows = torch.arange(cap)[None, :] >= counts[:, None]
    assert not bool(buf[rows].any())


@pytest.mark.parametrize("cf,b,s,mlp", [(8.0, 1, 1, "swiglu"),
                                        (8.0, 2, 12, "swiglu"),
                                        (1.0, 3, 10, "swiglu"),
                                        (0.5, 2, 16, "relu2")])
def test_expert_matmul_counts_on_dispatched_buffers(cf, b, s, mlp):
    """On a dispatched buffer ``expert_matmul_ref(x, w, counts)`` equals
    the unmasked form bit for bit (the dead rows are zero already) and
    gives zeros for experts with no row; so does the expert FFN with and
    without counts, and the wrapper on CPU tensors is the plain version."""
    _, _, arch, layer = _moe_block(DEEPSEEK)
    arch = dataclasses.replace(arch, moe_capacity_factor=cf, mlp=mlp)
    rng = np.random.RandomState(b * 100 + s)
    h = torch.from_numpy(rng.standard_normal((b, s, arch.d_model))
                         .astype(np.float32))
    buf, idx, _, _, cap = _dispatched(arch, layer, h)
    counts = M.expert_counts(arch, idx, cap)
    w = layer.moe.w_up
    masked = ops.expert_matmul_ref(buf, w, counts)
    assert torch.equal(masked, ops.expert_matmul_ref(buf, w))
    assert torch.equal(ops.expert_matmul(buf, w, counts), masked)
    empty = counts == 0
    assert bool(empty.any()) or b * s > 1  # one token: top k of E experts
    assert not bool(masked[empty].any())
    assert torch.equal(M.expert_ffn(arch, layer.moe, buf, counts),
                       M.expert_ffn(arch, layer.moe, buf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_matmul_ref_zeroes_rows_past_counts(dtype):
    """With random rows everywhere, the rows at or past ``counts[e]``
    come out +0 and the rest equal the unmasked product."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.standard_normal((5, 7, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 24, 16)).astype(np.float32))
    x, w = x.to(dtype), w.to(dtype)
    counts = torch.tensor([0, 7, 3, 1, 9], dtype=torch.int32)
    got = ops.expert_matmul_ref(x, w, counts)
    full = ops.expert_matmul_ref(x, w)
    for e, c in enumerate(counts.tolist()):
        c = min(c, 7)
        assert torch.equal(got[e, :c], full[e, :c])
        assert torch.equal(got[e, c:], torch.zeros_like(got[e, c:]))
        assert not bool(torch.signbit(got[e, c:]).any())  # +0
    with pytest.raises(ValueError, match="counts"):
        ops.expert_matmul(x, w, counts[:3])


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
    # INT8 serves (it raised before quant_matmul_experts): router and
    # experts int8, the experts' scale one per column for every expert
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=2, max_len=16, quant=INT8_SERVE))
    experts = eng.model.layers[1].moe
    assert model.weights_quantized and eng.caches[0]["k"].dtype == torch.int8
    assert experts.w_up.q.dtype == torch.int8
    assert tuple(experts.w_up.scale.shape) == (1, 1, arch.moe_d_ff)
    assert eng.model.layers[1].router.q.dtype == torch.int8
    model = bridge.from_jax_params(tree, arch, device="cpu")
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


_QSTREAMS = {}


@pytest.mark.parametrize("paged", [False, True])
def test_int8_streams_match_jax_engine(paged):
    """``INT8_SERVE`` on deepseek-moe-16b's reduced config: greedy
    streams equal the JAX quantised engine's on the grid and on the pool
    (a flip only as a near-tie, the margin taken on the quantised
    model); the expert products run through ``quant_matmul_experts``'s
    plain version."""
    from repro import quant as JQ
    from test_torch_recurrent import NEAR_TIE
    from test_torch_step_graph import _margin
    prompts = _stream_prompts(DEEPSEEK)
    if paged not in _QSTREAMS:
        arch_j, params, _, _ = _pair(DEEPSEEK)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jeng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                  config=JServeConfig(
                                      slots=SLOTS, max_len=MAX_LEN,
                                      quant=JQ.INT8_SERVE,
                                      paging=JPagingConfig(paged=paged,
                                                           page_size=PS)))
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        jeng.run_until_drained(max_steps=2000)
        _QSTREAMS[paged] = {r.rid: list(r.out_tokens) for r in jeng.completed}
    want = _QSTREAMS[paged]
    _, _, arch, tree = _pair(DEEPSEEK)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, quant=INT8_SERVE,
        paging=PagingConfig(paged=paged, page_size=PS)))
    got = _drive(eng, prompts)
    assert set(got) == set(want)
    for rid in sorted(want):
        g, w = got[rid], want[rid]
        if g != w:
            j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
            margin = _margin(model, prompts[rid], w[:j])
            assert margin < NEAR_TIE and len(g) == len(w), \
                f"rid={rid}: port={g} jax={w} (first diff at {j}, top-2 " \
                f"margin {margin:.3e})"
            warnings.warn(f"rid={rid}: near-tie flip at {j} ({margin:.3e})")
    assert any(len(set(t)) > 2 for t in got.values()), got
    assert ("kps" in eng.caches[0]) == paged


def test_quant_expert_matmul_plain_version_matches_einsum():
    """``quant_matmul_experts``'s plain version against the reference's
    ``einsum("ecd,edf->ecf")`` on weights dequantised as
    ``dequantize_params`` does (one column scale for every expert), with
    live rows: rows past them +0; on CPU tensors the wrapper is it."""
    from repro import quant as JQ
    from repro_torch import quant as Q
    rng = np.random.RandomState(7)
    e, c, k, n = 8, 5, 64, 48
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    w = rng.standard_normal((2, e, k, n)).astype(np.float32)  # 2 layers
    wq = JQ.quantize(jnp.asarray(w), axis=(0, 1, 2))
    want = np.asarray(jnp.einsum("ecd,edf->ecf", x, JQ.dequantize(wq)[1]))
    counts = np.array([0, 5, 1, 3, 5, 2, 0, 4], np.int32)
    live = np.arange(c)[None, :, None] < counts[:, None, None]
    q_t = torch.from_numpy(np.array(wq.q[1]))
    s_t = torch.from_numpy(np.array(wq.scale[0]))  # [1, 1, N]
    got = ops.int8_expert_matmul_ref(torch.from_numpy(x), q_t, s_t,
                                     torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), np.where(live, want, 0.0), **TOL)
    assert (got.numpy()[~np.broadcast_to(live, got.shape)] == 0).all()
    assert not np.signbit(got.numpy()[~np.broadcast_to(live, got.shape)]).any()
    full = ops.int8_expert_matmul(torch.from_numpy(x), q_t, s_t)
    np.testing.assert_allclose(full.numpy(), want, **TOL)
    # the MoE FFN takes it for int8 expert leaves
    down = Q.quantize(torch.from_numpy(
        rng.standard_normal((e, n, k)).astype(np.float32)), axis=(0, 1))
    experts = type("Experts", (), dict(w_up=Q.QTensor(q_t, s_t),
                                       w_down=down))
    arch = dataclasses.replace(get_arch(DEEPSEEK).reduced(), mlp="relu2")
    h = M.expert_ffn(arch, experts, torch.from_numpy(x),
                     torch.from_numpy(counts))
    assert tuple(h.shape) == (e, c, k)
    with pytest.raises(ValueError, match="do not chain"):
        ops.int8_expert_matmul(torch.from_numpy(x), q_t[:, :3], s_t)
    with pytest.raises(ValueError, match="scale"):
        ops.int8_expert_matmul(torch.from_numpy(x), q_t, s_t[..., :3])


@pytest.mark.parametrize("c,x_scale", [(1, 1.0), (2, 1.0), (2, 1e3)])
def test_quant_expert_split_mirror_matches_einsum(c, x_scale):
    """``ref.quant_matmul_experts_split_ref`` (the decode route's order:
    each bf16 term of fp32 x times the int8 weight on its own, the terms
    summed last, the scale once) against the reference's
    ``einsum("ecd,edf->ecf")`` on its dequantised weights at C = 1 and 2
    with live rows, fp32, 2e-4 of the output's scale; rows past the live
    ones +0."""
    from repro import quant as JQ
    from repro_torch.kernels import ref
    rng = np.random.RandomState(11 + c)
    e, k, n = 8, 256, 64
    x = (x_scale * rng.standard_normal((e, c, k))).astype(np.float32)
    w = rng.standard_normal((2, e, k, n)).astype(np.float32)  # 2 layers
    wq = JQ.quantize(jnp.asarray(w), axis=(0, 1, 2))
    want = np.asarray(jnp.einsum("ecd,edf->ecf", x, JQ.dequantize(wq)[1]))
    counts = rng.randint(0, c + 1, size=e).astype(np.int32)
    counts[:2] = (0, c)
    live = np.arange(c)[None, :, None] < counts[:, None, None]
    got = ref.quant_matmul_experts_split_ref(
        torch.from_numpy(x), torch.from_numpy(np.array(wq.q[1])),
        torch.from_numpy(np.array(wq.scale[0])), torch.from_numpy(counts))
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, c, n)
    tol = 2e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), np.where(live, want, 0.0),
                               rtol=2e-4, atol=tol)
    dead = got.numpy()[~np.broadcast_to(live, got.shape)]
    assert (dead == 0).all() and not np.signbit(dead).any()


def test_expert_routes():
    """``xfer_matmul_experts``'s launch plan (plain Python): deepseek's
    expert products at decode stream the weights (bf16 ``stream_mma``,
    fp32 ``stream_rows``) with no split, since 64 experts' column tiles
    already fill the card; bf16 prefill groups take ``wgmma`` with the
    expert on grid z (64-row tiles of 128 columns at C <= 64, 128-row
    tiles above), fp32 ones ``tile``, never ``stream_cols``; one expert
    is the dense route, unchanged."""
    from repro_torch.kernels.xfer_matmul import route
    bf16, f32 = torch.bfloat16, torch.float32
    for k, n in ((2048, 1408), (1408, 2048)):
        rt = route(1, k, n, bf16, (n, 1), 132, experts=64)
        assert (rt.kernel, rt.splits) == ("stream_mma", 1)
        assert route(8, k, n, f32, (n, 1), 132, experts=64).kernel == \
            "stream_rows"
        for c in (60, 240, 480):
            rt = route(c, k, n, bf16, (n, 1), 132, experts=64)
            rows = 64 if c <= 64 else 128
            assert (rt.kernel, rt.rows, rt.splits) == ("wgmma", rows, 1)
            assert rt.grid == (-(-n // rt.cols), -(-c // rows))
            assert rt.cols == 128 or c > 64
            assert route(c, k, n, f32, (n, 1), 132, experts=64).kernel == "tile"
    assert route(2048, 2048, 1408, bf16, (1408, 1), 132).kernel == "wgmma"
    assert route(2048, 2048, 1408, bf16, (1408, 1), 132, experts=1) == \
        route(2048, 2048, 1408, bf16, (1408, 1), 132)
    # few experts of a long contraction split K as the dense route does
    rt = route(9, 4096, 64, bf16, (64, 1), 132, experts=2)
    assert rt.kernel == "stream_mma" and rt.splits > 1
    # quant_matmul_experts: stream_ex at decode (one block per expert and
    # 64 columns over the whole contraction: no split-K, fp32 x or bf16),
    # wgmma on x's terms at prefill with the expert on grid z, tile off
    # 16 bytes
    from repro_torch.kernels.quant_matmul import ex_smem
    from repro_torch.kernels.quant_matmul import route as qroute
    for dt in (f32, bf16):
        for c in (1, 2, 16):
            for k, n in ((2048, 1408), (1408, 2048)):
                rt = qroute(c, k, n, dt, (n, 1), 132, experts=64)
                assert (rt.kernel, rt.grid, rt.splits, rt.cols) == (
                    "stream_ex", (n // 64, 1), 1, 64)
                assert rt.c_args == (6, 64, 1)
                # the warps' rings, and only the rows of x, as given (no
                # terms): three blocks an SM at C = 1
                assert ex_smem(c, k, dt) == max(
                    8 * 6 * 16 * 80 + c * (k + 8) * dt.itemsize,
                    8 * c * (3 if dt == f32 else 1) * 64 * 4)
                assert c > 1 or 3 * (ex_smem(c, k, dt) + 1024) <= 233472
        # the dense decode route is unchanged
        assert qroute(1, 2048, 1408, dt, (1408, 1), 132).kernel == \
            "stream_mma"
        for c in (60, 240):
            rt = qroute(c, 2048, 1408, dt, (1408, 1), 132, experts=64)
            assert rt.kernel == "wgmma" and rt.grid == (11, -(-c // 128))
    assert qroute(1, 1000, 1001, f32, (1001, 1), 132, aligned=False,
                  experts=5).kernel == "tile"
    assert qroute(1, 1024, 1024, f32, (1, 1024), 132,
                  experts=2).kernel != "stream_cols"
