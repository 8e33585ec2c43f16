"""The port's vlm family (paligemma-3b, ``.reduced()``: MQA, GeGLU, tied
embeddings, a patch prefix of ``frontend_tokens``) against the JAX
package on the same weights (carried over by ``repro_torch.bridge``),
fp32 on the CPU, at 2e-4 (the tests/test_kernels.py fp32 tolerance):

* the config, full and reduced, field by field;
* the plain version of ``flash_attention``'s prefix-LM form against
  ``repro.models.layers.attention(..., prefix_len=...)``;
* ``LM.forward(prefix_embeds=)`` (hidden states and logits) against the
  JAX ``forward``;
* greedy streams of patched and text-only requests mixed, on the slot
  grid and the page pool (pages of 4, text-only prompts sharing a prefix
  through the registry), against the JAX engine at lookahead 0 and 1,
  and one top-k stream set;
* admission: positions after one step (``tests/test_serving.py``'s 5
  and 11), batched equal to serial, patched prompts kept out of the
  prefix registry;
* INT8 streams against the JAX quantised engine, grid and pool;
* the refusals (speculative decoding).
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
from repro.serving import sampler as JS
from repro.serving.config import PagingConfig as JPagingConfig
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.quant import INT8_SERVE, QuantConfig
from test_torch_paging import jax_int8_shared_prefill  # noqa: F401
from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                 ServeConfig, ServingEngine, SpecConfig)
from repro_torch.serving import sampler as S

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_ID = "paligemma-3b"
SLOTS, MAX_LEN, MAX_NEW, PS, SEED = 2, 32, 5, 4, 0
TOP_K = SamplingParams("top_k", 0.8, 5)
MARGIN_TOL = 2e-4


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


_TREE = {}


def _pair():
    """(JAX arch, JAX params, port arch, numpy tree) of the reduced
    config, with seeded norms and 8x output projections (streams that do
    not repeat one token)."""
    if not _TREE:
        arch_j = jax_get_arch(ARCH_ID).reduced()
        init = jax.jit(JREG.init_params, static_argnums=(0, 2))
        tree = jax.tree.map(np.asarray, init(arch_j, jax.random.PRNGKey(SEED),
                                             jnp.float32))
        rng = np.random.RandomState(SEED + 1)
        body = dict(tree["body"]["b0_attn"])
        for k in ("ln1", "ln2"):
            body[k] = (0.5 * rng.standard_normal(body[k].shape)).astype(np.float32)
        body["wo"] = body["wo"] * 8.0
        body["mlp"] = dict(body["mlp"], w_down=body["mlp"]["w_down"] * 8.0)
        _TREE["t"] = dict(tree, body={"b0_attn": body})
    tree = _TREE["t"]
    return (jax_get_arch(ARCH_ID).reduced(), jax.tree.map(jnp.asarray, tree),
            get_arch(ARCH_ID).reduced(), tree)


def _model():
    _, _, arch, tree = _pair()
    return bridge.from_jax_params(tree, arch, device="cpu")


def test_config_matches_jax():
    for reduce in (False, True):
        a, b = get_arch(ARCH_ID), jax_get_arch(ARCH_ID)
        if reduce:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    arch = get_arch(ARCH_ID)
    assert (arch.family, arch.num_kv_heads, arch.head_dim, arch.mlp,
            arch.frontend_tokens, arch.tie_embeddings) == \
        ("vlm", 1, 256, "geglu", 256, True)


@pytest.mark.parametrize("s,p", [(13, 5), (20, 8), (6, 6)])
def test_prefix_lm_plain_version_matches_jax(s, p):
    rng = np.random.RandomState(s + p)
    b, h, g, d = 2, 4, 1, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, g, d)).astype(np.float32)
            for _ in range(2))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = np.asarray(JL.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos, None,
        causal=True, prefix_len=jnp.full((b,), p, jnp.int32)))
    from repro_torch.models import layers as L
    got = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), prefix_len=p)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # queries inside the prefix see all of it: not the causal result
    causal = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v))
    assert not np.allclose(causal[:, :p - 1].numpy(), want[:, :p - 1])
    np.testing.assert_allclose(causal[:, p:].numpy(), want[:, p:], **TOL)
    with pytest.raises(ValueError, match="prefix_len"):
        ops.attention(torch.zeros(2, s, d), torch.zeros(2, s, d),
                      torch.zeros(2, s, d), causal=False, prefix_len=p)


def test_forward_with_patches_matches_jax():
    arch_j, params, arch, _ = _pair()
    model = _model()
    rng = np.random.RandomState(6)
    n_patch = arch.frontend_tokens
    toks = rng.randint(1, arch.vocab_size, size=(3, 9)).astype(np.int32)
    patches = rng.standard_normal((3, n_patch, arch.d_model)).astype(np.float32)
    hj, _ = JLM.forward(arch_j, params, jnp.asarray(toks),
                        prefix_embeds=jnp.asarray(patches))
    with torch.no_grad():
        ht, _ = model(torch.from_numpy(toks),
                      prefix_embeds=torch.from_numpy(patches))
        lt = model.logits(ht)
    assert ht.shape == (3, n_patch + 9, arch.d_model)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    np.testing.assert_allclose(lt.numpy(),
                               np.asarray(JLM.logits_fn(arch_j, params, hj)),
                               **TOL)


# ---------------------------- serving streams ----------------------------

def _workload(arch):
    """5 requests, rids 0, 2, 4 with patches, 1 and 3 text-only sharing a
    9-token prefix (two pages of 4 and a token), 4-9 prompt tokens."""
    rng = np.random.RandomState(4)
    shared = rng.randint(1, arch.vocab_size, size=2 * PS + 1).astype(np.int32)
    prompts, patches = [], []
    for rid, n in enumerate((4, 3, 9, 5, 6)):
        tail = rng.randint(1, arch.vocab_size, size=n).astype(np.int32)
        text = rid % 2 == 1
        prompts.append(np.concatenate([shared, tail]) if text else tail)
        patches.append(None if text else rng.standard_normal(
            (arch.frontend_tokens, arch.d_model)).astype(np.float32))
    return prompts, patches


_JAX_STREAMS = {}


def _jax_streams(paged, sampled, lookahead, int8=False):
    key = (paged, sampled, lookahead, int8)
    if key not in _JAX_STREAMS:
        arch_j, params, _, _ = _pair()
        extra = {}
        if int8:
            from repro import quant as JQ
            extra["quant"] = JQ.INT8_SERVE
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
        prompts, patches = _workload(arch_j)
        for i, (p, pa) in enumerate(zip(prompts, patches)):
            eng.submit(JRequest(rid=i, prompt=p.copy(), patch_embeds=pa,
                                max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=300)
        _JAX_STREAMS[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _JAX_STREAMS[key]


def _port_engine(paged, sampled, lookahead, slots=SLOTS, int8=False):
    _, _, arch, _ = _pair()
    return ServingEngine(arch, _model(), device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, lookahead=lookahead,
        sampling=TOP_K if sampled else None,
        paging=PagingConfig(paged=paged, page_size=PS),
        quant=INT8_SERVE if int8 else QuantConfig()))


def _drive(eng, prompts, patches):
    for i, (p, pa) in enumerate(zip(prompts, patches)):
        eng.submit(Request(rid=i, prompt=p.copy(), patch_embeds=pa,
                           max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=300)
    return {r.rid: list(r.out_tokens) for r in eng.completed}


def _margin(model, patches, prompt, prefix, rid, sp=None) -> float:
    """Top-2 margin at the token after ``prompt + prefix`` (patches
    ahead): of the logits relative to their largest |value| (greedy), or
    of ``logits / T + gumbel`` with the request's key (sampled)."""
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    extra = {} if patches is None else {
        "prefix_embeds": torch.from_numpy(patches)[None]}
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(toks.astype(np.int32))[None],
                          **extra)
        row = model.logits(hidden[:, -1]).float()
    if sp is None:
        top = torch.topk(row[0], 2).values
        return float(top[0] - top[1]) / float(row.abs().max())
    row = S.top_k_mask(row / sp.temperature, sp.top_k)
    key = S.fold_in(S.prng_key(SEED), torch.tensor([rid]))
    for _ in prefix:
        key = S.split(key)[0]
    z = row + S.gumbel(S.split(key)[1], row.shape[-1])
    top = torch.topk(z[0], 2).values
    return float(top[0] - top[1])


def _stream_diff(model, got, want, sp=None):
    prompts, patches = _workload(model.arch)
    bad = []
    for rid in sorted(want):
        g, w = got.get(rid) or [], want[rid]
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        m = _margin(model, patches[rid], prompts[rid], w[:j], rid, sp)
        if m >= MARGIN_TOL:
            bad.append(f"rid={rid}: port={g} jax={w} (first diff at {j}, "
                       f"top-2 margin {m:.3e})")
    if set(got) != set(want):
        bad.append(f"completed sets differ: {sorted(got)} vs {sorted(want)}")
    return bad


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("paged", [False, True])
def test_greedy_streams_match_jax_engine(paged, lookahead):
    eng = _port_engine(paged, False, lookahead)
    prompts, patches = _workload(eng.arch)
    got = _drive(eng, prompts, patches)
    bad = _stream_diff(eng.model, got, _jax_streams(paged, False, lookahead))
    assert not bad, bad
    assert len(got) == 5 and all(len(t) == MAX_NEW for t in got.values())
    assert any(len(set(t)) > 2 for t in got.values()), got
    if paged:
        assert "kp" in eng.caches[0]
        # rid 3 shares rid 1's text prefix; patched prompts never register
        stats = eng.prefill_stats()
        assert stats["prefix_hit_rate"] > 0 and stats["shared_dispatches"] >= 1
        reg = eng.scheduler.registry
        keys = {bytes(k) for k in list(reg.full) + list(reg.tail)}
        for p, pa in zip(prompts, patches):
            if pa is not None:
                assert reg._key(p) not in keys


@pytest.mark.parametrize("paged", [False, True])
def test_top_k_streams_match_jax_engine(paged):
    eng = _port_engine(paged, True, 1)
    prompts, patches = _workload(eng.arch)
    got = _drive(eng, prompts, patches)
    bad = _stream_diff(eng.model, got, _jax_streams(paged, True, 1), TOP_K)
    assert not bad, bad


def test_admission_positions_and_batching():
    """tests/test_serving.py's vlm admission: 6 patches and a 4-token
    prompt start decoding at 10, the prompt alone at 4; one step later
    5 and 11. Batched admission equals one request at a time."""
    _, _, arch, _ = _pair()
    rng = np.random.RandomState(4)
    prompt = rng.randint(1, 100, size=4).astype(np.int32)
    patch_sets = [rng.standard_normal((6, arch.d_model)).astype(np.float32)
                  for _ in range(2)]
    eng = _port_engine(False, False, 1)
    eng.submit(Request(rid=0, prompt=prompt.copy(), patch_embeds=patch_sets[0],
                       max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=prompt.copy(), max_new_tokens=2))
    eng.step()
    assert sorted(eng.state.positions[:, 0].tolist()) == [5, 11]

    def run(slots):
        e = _port_engine(False, False, 1, slots=slots)
        return _drive(e, [prompt] * 2, patch_sets)

    batched, serial = run(2), run(1)
    assert batched == serial and len(batched) == 2
    # the patches reach the logits
    model = _model()
    with torch.no_grad():
        h0, _ = model(torch.from_numpy(prompt)[None])
        h1, _ = model(torch.from_numpy(prompt)[None],
                      prefix_embeds=torch.from_numpy(patch_sets[0])[None])
    assert not torch.allclose(model.logits(h0[:, -1]), model.logits(h1[:, -1]))


@pytest.mark.parametrize("paged", [False, True])
def test_submit_and_refusals(paged, jax_int8_shared_prefill):
    """Submit validation; INT8 serves (it raised before the vlm leaves
    were quantised by the reference's stack structure): greedy streams
    equal the JAX quantised engine's on the grid and the pool (the
    registry's shared-prefix prefill included), patches cast to the fp32
    activations; speculative decoding still raises."""
    _, _, arch, _ = _pair()
    qeng = _port_engine(paged, False, 1, int8=True)
    prompts, patches = _workload(qeng.arch)
    got = _drive(qeng, prompts, patches)
    bad = _stream_diff(qeng.model, got, _jax_streams(paged, False, 1,
                                                     int8=True))
    assert not bad, bad
    assert qeng.model.weights_quantized
    assert qeng.caches[0]["kp" if paged else "k"].dtype == torch.int8
    if paged:
        assert qeng.prefill_stats()["shared_dispatches"] >= 1
    eng = _port_engine(False, False, 1)
    assert eng.state.enc_out is None and eng.state.enc_len is None
    prompt = np.arange(1, 4, dtype=np.int32)
    with pytest.raises(ValueError, match="encdec payload"):
        eng.submit(Request(rid=0, prompt=prompt,
                           src_frames=np.zeros((2, arch.d_model), np.float32)))
    with pytest.raises(ValueError, match="incl. prefix"):
        eng.submit(Request(rid=1, prompt=np.arange(1, 30, dtype=np.int32),
                           patch_embeds=np.zeros((8, arch.d_model),
                                                 np.float32)))
    with pytest.raises(NotImplementedError, match="dense-attention"):
        ServingEngine(arch, {"target": _model(), "draft": _model()},
                      device="cpu", config=ServeConfig(
                          slots=2, max_len=16,
                          spec=SpecConfig(draft=arch, k=2)))
