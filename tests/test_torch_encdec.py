"""The port's encdec family (``models/encdec.py``; seamless-m4t-medium,
``.reduced()``) against the JAX package on the same weights (carried over
by ``repro_torch.bridge``), fp32 on the CPU, at 2e-4 (the
tests/test_kernels.py fp32 tolerance):

* the config, full and reduced, field by field;
* the plain version of ``flash_attention``'s non-causal form with
  per-row key lengths against ``repro.models.layers.attention(...,
  causal=False, kv_valid=...)`` (a row of length 0 gives 0 in the port,
  the mean of V in the reference: only inert slots have one);
* ``AttnBlock.cross_attend`` against ``blocks.cross_attn_apply`` in
  prefill (``flash_attention``) and decode (``paged_attention`` over the
  encoder positions, length 0 included);
* ``EncDec.encode`` against ``encdec.encode`` (the valid rows of a
  padded batch also equal the unpadded encoding) and ``EncDec.decode``
  (a prefill into caches, then decode steps) against ``encdec.decode``;
* greedy streams of 5 requests of mixed source lengths on 2 slots
  against the JAX engine (``tests/test_serving.py``'s mixed encdec
  workload) at lookahead 0 and 1, and one top-k stream set;
* submit validation (frames required, ``max_src_len``, the wrong
  payload for the family), INT8 streams against the JAX quantised engine
  and the refusals (speculative decoding,
  the paged pool).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import blocks as JB
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models import registry as JREG
from repro.serving import sampler as JS
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.quant import INT8_SERVE, QuantConfig
from repro_torch.serving import (PagingConfig, Request,
                                 RequestValidationError, SamplingParams,
                                 ServeConfig, ServingEngine, SpecConfig)
from repro_torch.serving import sampler as S

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_ID = "seamless-m4t-medium"
SLOTS, MAX_LEN, MAX_SRC, MAX_NEW, SEED = 2, 32, 16, 4, 0
TOP_K = SamplingParams("top_k", 0.8, 5)
MARGIN_TOL = 2e-4


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


def _liven(tree: dict, seed: int) -> dict:
    """Seeded norms and 8x output projections in both stacks, so that
    greedy streams do not repeat one token."""
    rng = np.random.RandomState(seed)

    def stack(b):
        b = dict(b)
        for k in ("ln1", "ln2", "ln_x"):
            if k in b:
                b[k] = (0.5 * rng.standard_normal(b[k].shape)).astype(np.float32)
        for k in ("wo", "xwo"):
            if k in b:
                b[k] = b[k] * 8.0
        b["mlp"] = dict(b["mlp"], w_down=b["mlp"]["w_down"] * 8.0)
        return b

    return dict(tree, enc_body=stack(tree["enc_body"]),
                dec_body=stack(tree["dec_body"]))


_TREE = {}


def _pair():
    """(JAX arch, JAX params, port arch, numpy tree) of the reduced
    config."""
    if not _TREE:
        arch_j = jax_get_arch(ARCH_ID).reduced()
        init = jax.jit(JREG.init_params, static_argnums=(0, 2))
        _TREE["t"] = _liven(jax.tree.map(np.asarray, init(
            arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
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
    assert (arch.family, arch.enc_layers, arch.dec_layers) == ("encdec", 12, 12)
    model = _model()
    assert len(model.enc_layers) == 2 and len(model.dec_layers) == 2
    assert model.dec_layers[0].is_cross and not model.enc_layers[0].is_cross


@pytest.mark.parametrize("s,t", [(7, 11), (16, 16), (1, 9)])
def test_noncausal_kv_len_plain_version_matches_jax(s, t):
    rng = np.random.RandomState(s * 10 + t)
    b, h, d = 3, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(2))
    lens = np.array([t, 3, 0], np.int32)
    valid = np.arange(t)[None] < lens[:, None]
    want = np.asarray(JL.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.zeros((b, s), jnp.int32), jnp.zeros((b, t), jnp.int32),
        jnp.asarray(valid), causal=False))

    def fold(x):
        return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(b * h, -1, d)

    got = ops.attention(fold(q), fold(k), fold(v), causal=False,
                        kv_len=torch.from_numpy(lens))
    got = got.reshape(b, h, s, d).permute(0, 2, 1, 3).numpy()
    np.testing.assert_allclose(got[:2], want[:2], **TOL)
    assert not got[2].any()  # no visible key: 0 (the reference: mean of V)
    # the same through the model's layers.attention (GQA broadcast)
    from repro_torch.models import layers as L
    got2 = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=False,
                       kv_len=torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got2[:2], want[:2], **TOL)
    with pytest.raises(ValueError, match="kv_len"):  # 5 does not divide BH
        ops.attention(fold(q), fold(k), fold(v), causal=False,
                      kv_len=torch.zeros(5, dtype=torch.int32))


def _dec_block(i=0):
    arch_j, params, arch, _ = _pair()
    model = _model()
    p = jax.tree.map(lambda a: a[i], params["dec_body"])
    return arch_j, p, arch, model.dec_layers[i]


@pytest.mark.parametrize("s", [1, 6])
def test_cross_attend_matches_jax(s):
    arch_j, p, arch, layer = _dec_block(1)
    rng = np.random.RandomState(s)
    b, t = 3, 9
    x = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
    enc = rng.standard_normal((b, t, arch.d_model)).astype(np.float32)
    lens = np.array([9, 4, 1], np.int32)
    want = JB.cross_attn_apply(arch_j, p, jnp.asarray(x), jnp.asarray(enc),
                               enc_lens=jnp.asarray(lens))
    got = layer.cross_attend(torch.from_numpy(x), torch.from_numpy(enc),
                             torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # an inert slot (enc_len 0): finite, and only the residual plus xwo of
    # zeros
    lens0 = np.array([9, 0, 1], np.int32)
    got0 = layer.cross_attend(torch.from_numpy(x), torch.from_numpy(enc),
                              torch.from_numpy(lens0))
    np.testing.assert_allclose(got0[1].numpy(), x[1], **TOL)
    np.testing.assert_allclose(got0[[0, 2]].numpy(), got[[0, 2]].numpy(),
                               **TOL)


def _frames(rng, counts, d):
    return [rng.standard_normal((f, d)).astype(np.float32) for f in counts]


def test_encode_matches_jax_and_padding():
    arch_j, params, arch, _ = _pair()
    model = _model()
    rng = np.random.RandomState(11)
    counts = (3, 9, 16)
    frames = _frames(rng, counts, arch.d_model)
    grid = np.zeros((3, MAX_SRC, arch.d_model), np.float32)
    for i, f in enumerate(frames):
        grid[i, :len(f)] = f
    lens = np.asarray(counts, np.int32)
    want = np.asarray(JED.encode(arch_j, params, jnp.asarray(grid),
                                 enc_lens=jnp.asarray(lens)))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(grid),
                           torch.from_numpy(lens)).numpy()
        for i, f in enumerate(frames):  # valid rows == the unpadded row
            np.testing.assert_allclose(got[i, :len(f)], want[i, :len(f)],
                                       **TOL)
            alone = model.encode(torch.from_numpy(f)[None]).numpy()[0]
            np.testing.assert_allclose(got[i, :len(f)], alone, **TOL)


def test_decode_prefill_and_steps_match_jax():
    arch_j, params, arch, _ = _pair()
    model = _model()
    rng = np.random.RandomState(12)
    b, s, t, steps = 2, 8, 12, 3
    toks = rng.randint(1, arch.vocab_size, size=(b, s)).astype(np.int32)
    enc = rng.standard_normal((b, t, arch.d_model)).astype(np.float32)
    lens = np.array([12, 5], np.int32)
    caches_j = JED.make_caches(arch_j, b, 16, jnp.float32)
    hj, caches_j = JED.decode(arch_j, params, jnp.asarray(toks),
                              jnp.asarray(enc), caches=caches_j,
                              enc_lens=jnp.asarray(lens))
    with torch.no_grad():
        caches = model.make_caches(b, 16)
        ht, caches = model(torch.from_numpy(toks), torch.from_numpy(enc),
                           caches=caches, enc_lens=torch.from_numpy(lens))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        for j in range(steps):
            nxt = rng.randint(1, arch.vocab_size, size=(b, 1)).astype(np.int32)
            pos = np.full((b, 1), s + j, np.int32)
            hj, caches_j = JED.decode(arch_j, params, jnp.asarray(nxt),
                                      jnp.asarray(enc), caches=caches_j,
                                      positions=jnp.asarray(pos),
                                      enc_lens=jnp.asarray(lens))
            ht, same = model(torch.from_numpy(nxt), torch.from_numpy(enc),
                             caches=caches, positions=torch.from_numpy(pos),
                             enc_lens=torch.from_numpy(lens))
            assert same is caches  # a decode step writes in place
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
            np.testing.assert_allclose(
                model.logits(ht).numpy(),
                np.asarray(hj @ params["unembed"]), **TOL)


# ---------------------------- serving streams ----------------------------

def _workload(arch):
    """tests/test_serving.py's mixed encdec workload: 5 prompts of 4-7
    tokens, 2-16 source frames."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 100, size=s).astype(np.int32)
               for s in (4, 6, 5, 4, 7)]
    frames = _frames(rng, (3, 9, 16, 2, 6), arch.d_model)
    return prompts, frames


_JAX_STREAMS = {}


def _jax_streams(sampled, lookahead, int8=False):
    key = (sampled, lookahead, int8)
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
                                     max_src_len=MAX_SRC,
                                     lookahead=lookahead, **extra))
        prompts, frames = _workload(arch_j)
        for i, (p, f) in enumerate(zip(prompts, frames)):
            eng.submit(JRequest(rid=i, prompt=p.copy(), src_frames=f,
                                max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=200)
        _JAX_STREAMS[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _JAX_STREAMS[key]


def _port_streams(sampled, lookahead, int8=False):
    _, _, arch, _ = _pair()
    eng = ServingEngine(arch, _model(), device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, max_src_len=MAX_SRC,
        lookahead=lookahead, sampling=TOP_K if sampled else None,
        quant=INT8_SERVE if int8 else QuantConfig()))
    prompts, frames = _workload(arch)
    for i, (p, f) in enumerate(zip(prompts, frames)):
        eng.submit(Request(rid=i, prompt=p.copy(), src_frames=f,
                           max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=200)
    return eng, {r.rid: list(r.out_tokens) for r in eng.completed}


def _margin(model, frames, prompt, prefix, rid, sp=None) -> float:
    """Top-2 margin at the token after ``prompt + prefix``: of the logits
    relative to their largest |value| (greedy), or of ``logits / T +
    gumbel`` with the request's key (sampled)."""
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    with torch.no_grad():
        enc = model.encode(torch.from_numpy(frames)[None])
        hidden, _ = model(torch.from_numpy(toks.astype(np.int32))[None], enc)
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


def _stream_diff(eng, got, want, sp=None):
    prompts, frames = _workload(eng.arch)
    bad = []
    for rid in sorted(want):
        g, w = got.get(rid) or [], want[rid]
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        m = _margin(eng.model, frames[rid], prompts[rid], w[:j], rid, sp)
        if m >= MARGIN_TOL:
            bad.append(f"rid={rid}: port={g} jax={w} (first diff at {j}, "
                       f"top-2 margin {m:.3e})")
    if set(got) != set(want):
        bad.append(f"completed sets differ: {sorted(got)} vs {sorted(want)}")
    return bad


@pytest.mark.parametrize("lookahead", [0, 1])
def test_greedy_streams_match_jax_engine(lookahead):
    eng, got = _port_streams(False, lookahead)
    want = _jax_streams(False, lookahead)
    bad = _stream_diff(eng, got, want)
    assert not bad, bad
    assert len(got) == 5 and all(len(t) == MAX_NEW for t in got.values())
    assert any(len(set(t)) > 1 for t in got.values()), got
    # 2 slots over 5 requests: admission in several waves, and every
    # slot's enc_len is a request's frame count
    assert eng.prefill_stats()["prefill_dispatches"] >= 3
    assert set(eng.state.enc_len.tolist()) <= {3, 9, 16, 2, 6}


def test_top_k_streams_match_jax_engine():
    eng, got = _port_streams(True, 1)
    bad = _stream_diff(eng, got, _jax_streams(True, 1), TOP_K)
    assert not bad, bad


def test_submit_validation():
    _, _, arch, tree = _pair()
    eng = ServingEngine(arch, _model(), device="cpu", config=ServeConfig(
        slots=1, max_len=16, max_src_len=8))
    assert eng.state.enc_out.shape == (1, 8, arch.d_model)
    prompt = np.arange(1, 4, dtype=np.int32)
    with pytest.raises(ValueError, match="needs.*frames"):
        eng.submit(Request(rid=0, prompt=prompt))
    with pytest.raises(ValueError, match="max_src_len"):
        eng.submit(Request(rid=1, prompt=prompt,
                           src_frames=np.zeros((9, arch.d_model), np.float32)))
    with pytest.raises(ValueError, match="vlm payload"):
        eng.submit(Request(rid=2, prompt=prompt,
                           src_frames=np.zeros((2, arch.d_model), np.float32),
                           patch_embeds=np.zeros((2, arch.d_model),
                                                 np.float32)))
    eng.submit(Request(rid=3, prompt=prompt,
                       src_frames=np.zeros((8, arch.d_model), np.float32),
                       max_new_tokens=2))
    eng.run_until_drained(max_steps=20)
    assert len(eng.completed) == 1
    # max_src_len defaults to max_len
    assert ServeConfig(slots=1, max_len=16).resolve().max_src_len == 16
    # src_frames to a decoder-only family
    dense = get_arch("qwen1.5-0.5b").reduced()
    from repro_torch.models.registry import init_params
    deng = ServingEngine(dense, init_params(dense, 0, device="cpu"),
                         device="cpu", config=ServeConfig(slots=1, max_len=16))
    with pytest.raises(ValueError, match="encdec payload"):
        deng.submit(Request(rid=0, prompt=prompt,
                            src_frames=np.zeros((2, dense.d_model), np.float32)))


def test_zero_frame_request_refused_where_the_jax_engine_admits_it():
    """The JAX engine serves a request with 0 source frames, its masked
    softmax averaging V over the padded encoder positions; the port's
    kernels give 0 for a row with no visible key, so it refuses the
    request at submit rather than serve another stream."""
    arch_j, params, arch, _ = _pair()
    prompt = np.arange(1, 5, dtype=np.int32)
    none = np.zeros((0, arch.d_model), np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JServingEngine(arch_j, params, dtype=jnp.float32,
                              config=JServeConfig(slots=SLOTS, max_len=MAX_LEN,
                                                  max_src_len=MAX_SRC))
    jeng.submit(JRequest(rid=0, prompt=prompt, src_frames=none,
                         max_new_tokens=MAX_NEW))
    jeng.run_until_drained(max_steps=50)
    assert [len(r.out_tokens) for r in jeng.completed] == [MAX_NEW]
    eng = ServingEngine(arch, _model(), device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, max_src_len=MAX_SRC))
    with pytest.raises(RequestValidationError, match="0 source frames"):
        eng.submit(Request(rid=0, prompt=prompt, src_frames=none,
                           max_new_tokens=MAX_NEW))
    assert not eng.scheduler.queue


def test_refusals():
    """INT8 serves (it raised before the encdec leaves were quantised by
    the reference's ``enc_body``/``dec_body`` stacks): greedy streams
    equal the JAX quantised engine's, the decoder grid int8, ``enc_out``
    in the engine's dtype, written from the fp32 encoder; speculative
    decoding still raises."""
    _, _, arch, _ = _pair()
    eng, got = _port_streams(False, 1, int8=True)
    bad = _stream_diff(eng, got, _jax_streams(False, 1, int8=True))
    assert not bad, bad
    assert eng.model.weights_quantized
    assert eng.caches[0]["k"].dtype == torch.int8
    assert eng.state.enc_out.dtype == torch.float32  # the engine's dtype
    assert len(got) == 5 and all(len(t) == MAX_NEW for t in got.values())
    with pytest.raises(NotImplementedError, match="dense-attention"):
        ServingEngine(arch, {"target": _model(), "draft": _model()},
                      device="cpu", config=ServeConfig(
                          slots=2, max_len=16,
                          spec=SpecConfig(draft=arch, k=2)))
    with pytest.raises(ValueError, match="paged KV cache"):
        ServingEngine(arch, _model(), device="cpu", config=ServeConfig(
            slots=2, max_len=16, paging=PagingConfig(paged=True,
                                                     page_size=4)))
