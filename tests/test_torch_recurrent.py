"""The port's hybrid family (recurrentgemma-2b) vs the JAX package, fp32
on the CPU, on ``recurrentgemma-2b.reduced()`` (4 layers: one (rglru,
rglru, attn) repeat of the scanned body plus one suffix rglru; d 64,
4 heads over 1 kv head of 16, lru width 64, window 16) with weights
carried over from ``repro.models.registry.init_params`` by
``repro_torch.bridge``.

Covered: the ``rglru_scan`` plain version against the JAX oracle and the
interpret-mode Pallas kernel (shapes where ``s % bs == 0``, which the TPU
kernel needs); ``_causal_conv`` (with and without true lengths) and
``_rglru_gates``; one RG-LRU block in a padded prefill and in decode;
``_ring_exact_fill`` with prompts shorter and longer than the window;
the whole forward with caches, leaf by leaf, through a decode that wraps
the ring; the bridge; greedy streams against the JAX ``ServingEngine``
and ``ReferenceEngine`` (``basic``, ``churn``, ``eos``, lookahead 0 and
1, ``max_len`` 48 so the window-16 ring wraps). Tolerance 2e-4 (fp32),
5e-2 for bf16 inputs, the tests/test_kernels.py tolerances.

The JAX package's associative scan does not keep a pad-free prefill
state bit-equal across buckets (ROADMAP C), so each comparison with JAX
runs both sides at the same padded length; the port's own state is
checked bit-equal across buckets 16 and 32.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as JB
from repro.models import lm as JLM
from repro.models import recurrent as JR
from repro.models import registry as JREG
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import ReferenceEngine, _prompts
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models import registry as REG
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.scheduler import bucket_floor, prefill_rows

ARCH_ID = "recurrentgemma-2b"
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN, MAX_NEW, SLOTS, SEED = 48, 16, 4, 0
#: a greedy flip counts as a near-tie only under this top-2 logit margin,
#: relative to the position's largest |logit| (the fp32 tolerance)
NEAR_TIE = 2e-4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _liven(tree: dict, seed: int) -> dict:
    """Seeded norms and biases and 8x output projections on every block,
    so that greedy streams do not repeat their first token and the
    recurrent gates leave their zero-bias fixed point."""
    rng = np.random.RandomState(seed)

    def block(b):
        b = dict(b)
        for k in ("ln1", "ln2", "conv_b", "gate_b"):
            if k in b:
                b[k] = (0.5 * rng.standard_normal(b[k].shape)).astype(np.float32)
        for k in ("w_out", "wo"):
            if k in b:
                b[k] = b[k] * 8.0
        b["mlp"] = dict(b["mlp"], w_down=b["mlp"]["w_down"] * 8.0)
        return b

    tree = dict(tree)
    tree["body"] = {k: block(v) for k, v in tree["body"].items()}
    for k in [k for k in tree if k.startswith("suffix")]:
        tree[k] = block(tree[k])
    return tree


@pytest.fixture(scope="module")
def pair():
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    tree = _liven(jax.tree.map(np.asarray, JREG.init_params(
        arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
    params = jax.tree.map(jnp.asarray, tree)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    return arch_j, params, arch, tree, model


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


def _tokens(lens, bucket, seed):
    rng = np.random.RandomState(seed)
    toks = np.zeros((len(lens), bucket), np.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = rng.randint(1, 256, size=s)
    return toks


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_arch_copy_matches_jax_config():
    for reduce in (False, True):
        a, b = get_arch(ARCH_ID), jax_get_arch(ARCH_ID)
        if reduce:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert bucket_floor(get_arch(ARCH_ID), 2560) == 2048
    assert bucket_floor(get_arch(ARCH_ID).reduced(), 48) == 16
    assert bucket_floor(get_arch(ARCH_ID).reduced(), 8) == 8
    assert bucket_floor(get_arch("qwen1.5-0.5b"), 2560) == 8


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,w,bs", [(2, 32, 64, 8), (3, 16, 48, 16),
                                      (1, 64, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_plain_matches_jax(b, s, w, bs, dtype):
    rng = np.random.RandomState(4)
    a = rng.uniform(0.5, 1.0, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = TOL if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    got = ops.lru_scan(_t(a).to(tdt), _t(x).to(tdt), _t(h0))
    assert got.dtype == tdt and got.shape == (b, s, w)
    aj, xj = jnp.asarray(a).astype(jdt), jnp.asarray(x).astype(jdt)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.rglru_scan_ref(aj, xj, jnp.asarray(h0)), np.float32), **tol)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jops.lru_scan(aj, xj, jnp.asarray(h0), bs=bs), np.float32),
        **tol)


def test_lru_scan_identity_steps_are_exact_and_s_is_free():
    """(a, b) = (1, 0) steps leave h bit-for-bit unchanged, at a length no
    TPU block size divides; the output is fp32's ``a * h + b``, step by
    step."""
    rng = np.random.RandomState(5)
    a = _t(rng.uniform(0.2, 1.0, (2, 37, 24)).astype(np.float32))
    x = _t(rng.standard_normal((2, 37, 24)).astype(np.float32))
    h0 = _t(rng.standard_normal((2, 24)).astype(np.float32))
    a[:, 20:], x[:, 20:] = 1.0, 0.0
    hs = ops.lru_scan(a, x, h0)
    assert torch.equal(hs[:, 20:], hs[:, 19:20].expand(-1, 17, -1))
    h = h0
    for t in range(37):
        h = a[:, t] * h + x[:, t]
        assert torch.equal(hs[:, t], h)
    with pytest.raises(ValueError):
        ops.lru_scan(a, x, h0[:, :5])
    with pytest.raises(TypeError):
        ops.lru_scan(a, x, h0.double())


# ---------------------------------------------------------------------------
# the RG-LRU block's parts and the block
# ---------------------------------------------------------------------------

def test_causal_conv_and_gates_match_jax(pair):
    _, params, arch, _, model = pair
    p = jax.tree.map(lambda x: x[0], params["body"]["b0_rglru"])
    layer = model.layers[0]
    rng = np.random.RandomState(6)
    x = rng.standard_normal((3, 12, 64)).astype(np.float32)
    state = rng.standard_normal((3, 3, 64)).astype(np.float32)
    lens = np.array([12, 5, 1], np.int32)
    for st in (None, state):
        for sl in (None, lens):
            yj, cj = JR._causal_conv(jnp.asarray(x), p["conv_w"], p["conv_b"],
                                     None if st is None else jnp.asarray(st),
                                     seq_lens=None if sl is None else jnp.asarray(sl))
            yt, ct = R._causal_conv(_t(x), layer.conv_w, layer.conv_b,
                                    None if st is None else _t(st),
                                    seq_lens=None if sl is None else _t(sl))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    log_a_j, b_j = JR._rglru_gates(p, jnp.asarray(x), arch.num_heads)
    log_a_t, b_t = R._rglru_gates(layer.gate_w, layer.gate_b, layer.a_param,
                                  _t(x), arch.num_heads)
    np.testing.assert_allclose(log_a_t.numpy(), np.asarray(log_a_j), **TOL)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), **TOL)


def test_rglru_block_prefill_and_decode_match_jax(pair):
    """A padded prefill from a non-zero state, then two decode steps:
    outputs at valid positions and the state leaves."""
    arch_j, params, arch, _, model = pair
    p = jax.tree.map(lambda x: x[0], params["body"]["b1_rglru"])
    layer = model.layers[1]
    rng = np.random.RandomState(7)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    lens = np.array([16, 9, 2], np.int32)
    st = {"h": rng.standard_normal((3, 64)).astype(np.float32),
          "conv": rng.standard_normal((3, 3, 64)).astype(np.float32)}
    yj, sj = JR.rglru_apply(arch_j, p, jnp.asarray(x),
                            state=jax.tree.map(jnp.asarray, st),
                            seq_lens=jnp.asarray(lens))
    yt, s_t = layer(_t(x), state={k: _t(v) for k, v in st.items()},
                    seq_lens=_t(lens))
    for i, s in enumerate(lens):
        np.testing.assert_allclose(yt[i, :s].numpy(), np.asarray(yj)[i, :s], **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(sj[k]), **TOL)
    decode_j = jax.jit(lambda x_, s_: JR.rglru_apply(arch_j, p, x_, state=s_))
    for step in range(2):
        xt = rng.standard_normal((3, 1, 64)).astype(np.float32)
        yj, sj = decode_j(jnp.asarray(xt), sj)
        yt, s_t = layer(_t(xt), state=s_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(s_t[k].numpy(), np.asarray(sj[k]), **TOL)


@pytest.mark.parametrize("lens", [[3, 16, 9], [20, 31, 17], [32, 1, 16]])
def test_ring_exact_fill_matches_jax(lens):
    """Prompts shorter than, equal to and longer than the 16-slot window,
    in a 32-long bucket."""
    arch = get_arch(ARCH_ID).reduced()
    rng = np.random.RandomState(8)
    k = rng.standard_normal((3, 32, 1, 16)).astype(np.float32)
    v = rng.standard_normal((3, 32, 1, 16)).astype(np.float32)
    lens = np.array(lens, np.int32)
    cj = JB._ring_exact_fill(JB.make_kv_cache(arch, 3, 32, jnp.float32, window=16),
                             jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), 32)
    cache = B.make_kv_cache(arch, 3, 32, device=torch.device("cpu"),
                            dtype=torch.float32, window=16)
    assert cache["k"].shape == (3, 16, 1, 16)
    ct = B._ring_exact_fill(cache, _t(k), _t(v), _t(lens))
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    valid = np.asarray(cj["pos"]) >= 0
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(ct[leaf].numpy()[valid],
                                      np.asarray(cj[leaf])[valid])
    assert (valid.sum(1) == np.minimum(lens, 16)).all()


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_bridge_maps_body_and_suffix(pair):
    arch_j, params, arch, tree, model = pair
    assert model.kinds == ["rglru", "rglru", "attn", "rglru"]
    body = tree["body"]
    for r in range(1):  # one body repeat
        for j, kind in enumerate(("rglru", "rglru", "attn")):
            layer = model.layers[3 * r + j]
            for name, leaf in dict(layer.named_parameters()).items():
                want = body[f"b{j}_{kind}"]
                for part in name.split("."):
                    want = want[part]
                np.testing.assert_array_equal(leaf.numpy(), want[r])
    np.testing.assert_array_equal(model.layers[3].a_param.numpy(),
                                  tree["suffix0"]["a_param"])
    np.testing.assert_array_equal(model.layers[3].mlp.w_up.numpy(),
                                  tree["suffix0"]["mlp"]["w_up"])
    for bad in ("extra_suffix", "extra_leaf"):
        broken = jax.tree.map(lambda x: x, tree)
        if bad == "extra_suffix":
            broken["suffix1"] = tree["suffix0"]
        else:
            broken["suffix0"] = dict(tree["suffix0"], extra=np.zeros(3, np.float32))
        with pytest.raises(KeyError):
            bridge.from_jax_params(broken, arch, device="cpu")


def test_forward_with_caches_matches_jax_leaf_by_leaf(pair):
    """A padded batched prefill (prompts shorter and longer than the
    window) into caches of the same padded length on both sides, then
    decode steps until every ring has wrapped: hidden states, logits,
    and every cache leaf (``h``, ``conv``, ring ``k``/``v``/``pos``)."""
    arch_j, params, arch, _, model = pair
    n, bucket = 3, 32
    lens = np.array([5, 32, 20], np.int32)
    toks = _tokens(lens, bucket, seed=9)
    h_j, c_j = JLM.forward(arch_j, params, jnp.asarray(toks),
                           caches=JREG.make_caches(arch_j, n, bucket, jnp.float32),
                           seq_lens=jnp.asarray(lens))
    h_t, c_t = model(_t(toks), caches=model.make_caches(n, bucket),
                     seq_lens=_t(lens))
    for i, s in enumerate(lens):
        np.testing.assert_allclose(h_t[i, :s].numpy(), np.asarray(h_j)[i, :s], **TOL)

    def jax_leaf(i):
        if i < 3:
            kind = model.kinds[i]
            return {k: np.asarray(v)[0] for k, v in c_j["body"][f"b{i}_{kind}"].items()}
        return {k: np.asarray(v) for k, v in c_j["suffix0"].items()}

    def check():
        for i, kind in enumerate(model.kinds):
            cj, ct = jax_leaf(i), {k: v.numpy() for k, v in c_t[i].items()}
            if kind == "rglru":
                assert set(ct) == {"h", "conv"}
                for k in ("h", "conv"):
                    np.testing.assert_allclose(ct[k], cj[k], **TOL, err_msg=f"{i}.{k}")
            else:
                assert ct["k"].shape[1] == arch.window
                np.testing.assert_array_equal(ct["pos"], cj["pos"])
                valid = cj["pos"] >= 0
                for k in ("k", "v"):
                    np.testing.assert_allclose(ct[k][valid], cj[k][valid], **TOL)

    check()
    decode_j = jax.jit(lambda p, t, c, q: JLM.forward(arch_j, p, t, caches=c,
                                                      positions=q))
    rng = np.random.RandomState(10)
    pos = lens.copy()
    for _ in range(14):  # row 0 reaches position 18: every ring wrapped
        tok = rng.randint(1, 256, size=(n, 1)).astype(np.int32)
        h_j, c_j = decode_j(params, jnp.asarray(tok), c_j,
                            jnp.asarray(pos[:, None]))
        h_t, c_t = model(_t(tok), caches=c_t, positions=_t(pos[:, None]))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
        np.testing.assert_allclose(
            model.logits(h_t).numpy(),
            np.asarray(JLM.logits_fn(arch_j, params, h_j)), **TOL)
        pos += 1
        check()
    assert (c_t[2]["pos"] >= 0).all()


def test_prefill_state_is_bit_equal_across_buckets(pair):
    """The port's pad-free prefill: the same prompts padded to 16 and to
    32 give bit-equal recurrent states, conv windows and rings, and
    bit-equal hidden states at every valid position (the JAX package's
    associative scan does not, ROADMAP C)."""
    _, _, arch, _, model = pair
    lens = np.array([5, 16, 11], np.int32)
    out = {}
    for bucket in (16, 32):
        toks = _tokens(lens, bucket, seed=11)
        rows, logits = prefill_rows(model, _t(toks), _t(lens))
        hidden, _ = model(_t(toks), caches=model.make_caches(3, bucket),
                          seq_lens=_t(lens))
        out[bucket] = rows, logits, hidden
    (r16, l16, h16), (r32, l32, h32) = out[16], out[32]
    for a, b in zip(r16, r32):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(l16, l32)
    for i, s in enumerate(lens):
        assert torch.equal(h16[i, :s], h32[i, :s])


def test_init_params_draws_rglru_init_distributions():
    import math
    arch = get_arch(ARCH_ID).reduced()
    a = REG.init_params(arch, 3, device="cpu")
    b = REG.init_params(arch, 3, device="cpu")
    assert a.kinds == ["rglru", "rglru", "attn", "rglru"]
    torch.testing.assert_close(a.layers[0].gate_w, b.layers[0].gate_w, rtol=0, atol=0)
    rg = a.layers[0]
    hw = arch.lru_width // arch.num_heads
    np.testing.assert_allclose(rg.a_param.numpy(),
                               np.linspace(0.9, 0.999, arch.lru_width), rtol=1e-6)
    assert float(rg.gate_w.abs().max()) <= 2.0 / math.sqrt(hw) + 1e-6
    assert float(rg.conv_w.abs().max()) <= 2.0 / math.sqrt(arch.conv1d_width) + 1e-6
    for name in ("ln1", "ln2", "conv_b", "gate_b"):
        assert float(getattr(rg, name).abs().max()) == 0.0
    assert float(rg.w_in.std()) > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _scenario(name):
    arch = jax_get_arch(ARCH_ID).reduced()
    if name == "basic":
        return _prompts(arch, SLOTS, MAX_LEN, SEED, MAX_NEW), SLOTS
    if name == "churn":
        return _prompts(arch, 6, MAX_LEN, SEED + 1, MAX_NEW), 2
    return _prompts(arch, 3, MAX_LEN, SEED + 2, MAX_NEW), 2


_JAX_STREAMS = {}


def _jax_streams(pair, engine, name, eos_id=None):
    key = (engine, name, eos_id)
    if key not in _JAX_STREAMS:
        arch_j, params, _, _, _ = pair
        prompts, slots = _scenario(name)
        if engine == "reference":
            eng = ReferenceEngine(arch_j, params, slots=slots, max_len=MAX_LEN,
                                  eos_id=eos_id, dtype=jnp.float32)
        else:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                eng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                     config=JServeConfig(slots=slots,
                                                         max_len=MAX_LEN,
                                                         eos_id=eos_id))
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=2000)
        _JAX_STREAMS[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _JAX_STREAMS[key]


def _port_streams(pair, name, lookahead, eos_id=None):
    _, _, arch, tree, _ = pair
    prompts, slots = _scenario(name)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, eos_id=eos_id, lookahead=lookahead))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=2000)
    return model, prompts, {r.rid: list(r.out_tokens) for r in eng.completed}


def _flips(model, prompts, got, want):
    """Streams that differ, each with the top-2 logit margin (relative
    to the largest |logit|) of the port's model at the first difference;
    a flip under NEAR_TIE is a near-tie, anything else a fault."""
    faults, ties = [], []
    for rid in sorted(want):
        g, w = got.get(rid) or [], want[rid]
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        toks = np.concatenate([prompts[rid], np.asarray(w[:j], np.int32)])
        hidden, _ = model(_t(toks.astype(np.int32))[None])
        logits = model.logits(hidden[:, -1]).float()[0]
        top = torch.topk(logits, 2).values
        margin = float(top[0] - top[1]) / float(logits.abs().max())
        msg = (f"rid={rid}: port={g} jax={w} (first diff at {j}, top-2 "
               f"margin {margin:.3e})")
        (ties if margin < NEAR_TIE and len(g) == len(w) else faults).append(msg)
    if set(got) != set(want):
        faults.append(f"completed sets differ: {sorted(got)} vs {sorted(want)}")
    return faults, ties


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("scenario", ["basic", "churn", "eos"])
def test_greedy_streams_match_jax_engines(pair, scenario, lookahead):
    eos_ids = [None]
    if scenario == "eos":  # EOS straight out of prefill, and mid-stream
        probe = _jax_streams(pair, "reference", "eos")
        eos_ids = [probe[0][0], probe[1][3]]
    for eos in eos_ids:
        model, prompts, got = _port_streams(pair, scenario, lookahead, eos)
        for engine in ("reference", "serving"):
            want = _jax_streams(pair, engine, scenario, eos)
            faults, ties = _flips(model, prompts, got, want)
            assert not faults, f"{engine} eos={eos}: {faults}"
            if ties:
                warnings.warn(f"near-tie flips vs {engine}: {ties}")
        if scenario == "eos":
            assert any(len(t) < MAX_NEW for t in want.values()), want
    if scenario == "basic":  # live streams, and decode wraps the ring
        assert any(len(set(t)) > 4 for t in got.values()), got
        assert max(len(p) for p in prompts) + MAX_NEW > get_arch(ARCH_ID).reduced().window


_QSTREAMS = {}


def _jax_int8_streams(pair, quant):
    """Streams of the JAX ``ServingEngine`` under ``quant`` (the basic
    scenario, fp32)."""
    from repro import quant as JQ
    key = (quant.weights, quant.kv)
    if key not in _QSTREAMS:
        arch_j, params, _, _, _ = pair
        prompts, slots = _scenario("basic")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                 config=JServeConfig(
                                     slots=slots, max_len=MAX_LEN,
                                     quant=JQ.QuantConfig(*key)))
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=2000)
        _QSTREAMS[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _QSTREAMS[key]


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("quant", ["int8", "kv"])
def test_hybrid_int8_serving_raises(pair, quant, lookahead):
    """INT8 serving of the hybrid family (it raised before the family's
    leaves were quantised by the reference's stack structure): under
    ``INT8_SERVE`` and ``QuantConfig(kv="int8")`` the streams equal the
    JAX quantised engine's, the ring an int8 grid with scales, the
    RG-LRU recurrence in fp32; a flip only as a near-tie."""
    from repro_torch.quant import INT8_SERVE, QuantConfig
    _, _, arch, tree, _ = pair
    config = INT8_SERVE if quant == "int8" else QuantConfig(kv="int8")
    prompts, slots = _scenario("basic")
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, lookahead=lookahead, quant=config))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=2000)
    got = {r.rid: list(r.out_tokens) for r in eng.completed}
    faults, ties = _flips(model, prompts, got, _jax_int8_streams(pair, config))
    assert not faults, faults
    if ties:
        warnings.warn(f"near-tie flips: {ties}")
    assert model.weights_quantized == config.quant_weights
    attn = [c for c in eng.caches if "k" in c]
    assert attn and all(c["k"].dtype == torch.int8 and "k_scale" in c
                        for c in attn)
    assert all(c["h"].dtype == torch.float32 for c in eng.caches if "h" in c)
    assert any(len(set(t)) > 4 for t in got.values()), got


def test_serve_launcher_runs_the_hybrid_on_cpu(capsys):
    from repro_torch.launch import serve
    engine = serve.main(["--arch", ARCH_ID, "--device", "cpu", "--requests", "3",
                         "--slots", "2", "--max-len", "40", "--new-tokens", "20"])
    assert len(engine.completed) == 3
    assert all(len(r.out_tokens) == 20 for r in engine.completed)
    assert "recurrentgemma-2b-smoke" in capsys.readouterr().out
