"""The port's ssm family (xlstm-350m) vs the JAX package, on the CPU, on
``xlstm-350m.reduced()`` (4 layers: two (mlstm, slstm) repeats of the
scanned body, no suffix; d 64, 4 heads; mLSTM inner width 128, so head
dim 32; vocab 256) with weights carried over from
``repro.models.registry.init_params`` by ``repro_torch.bridge``.

Covered: the ``mlstm_chunkwise`` plain version and the TPU-signature
entry against the interpret-mode Pallas kernel and the strict per-step
oracle (the tests/test_kernels.py shapes plus D = 32; 3e-3 in fp32, the
JAX test's tolerance, 5e-2 for bf16 inputs, whose outputs round to bf16
on both sides); the port's ``mlstm_ref`` against JAX's (2e-4);
identity-gate tails and a nonzero initial state; ``MLSTMBlock`` and
``SLSTMBlock`` in a padded prefill from a nonzero state and in decode,
against ``mlstm_apply`` and ``slstm_apply`` leaf by leaf (2e-4); the
bridge; ``init_params``; the whole forward with caches; greedy streams
against the JAX ``ServingEngine`` and ``ReferenceEngine`` (``basic``,
``churn``, ``eos``, lookahead 0 and 1); INT8 raising; the launcher.

The JAX mLSTM prefill picks its chunk from the padded length, so its
state is not bit-equal across buckets (ROADMAP C): each comparison with
JAX runs both sides at the same padded length. The port's own prefill
state is checked bit-equal across buckets 16 and 32.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
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
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mlstm_chunkwise import log_sigmoid
from repro_torch.models import registry as REG
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.scheduler import bucket_floor, prefill_rows

ARCH_ID = "xlstm-350m"
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_LEN, MAX_NEW, SLOTS, SEED = 48, 16, 4, 0
#: a greedy flip counts as a near-tie only under this top-2 logit margin,
#: relative to the position's largest |logit| (the fp32 tolerance)
NEAR_TIE = 2e-4
_NEG = -1e30


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _liven(tree: dict, seed: int) -> dict:
    """Seeded norms and gate biases and 8x output projections on every
    block: with the default init the greedy streams repeat one token."""
    rng = np.random.RandomState(seed)

    def block(b):
        b = dict(b)
        for k in ("ln1", "ln_inner", "b_i", "b_f", "b"):
            if k in b:
                b[k] = (0.5 * rng.standard_normal(b[k].shape)).astype(np.float32)
        for k in ("w_down", "w_out"):
            if k in b:
                b[k] = b[k] * 8.0
        return b

    tree = dict(tree)
    tree["body"] = {k: block(v) for k, v in tree["body"].items()}
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


def _qkvif(rng, bh, s, d):
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k = (rng.standard_normal((bh, s, d)) / np.sqrt(d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    it = rng.standard_normal((bh, s)).astype(np.float32)
    ft = (rng.standard_normal((bh, s)) + 2.0).astype(np.float32)
    return q, k, v, it, ft


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_arch_copy_matches_jax_config():
    for reduce in (False, True):
        a, b = get_arch(ARCH_ID), jax_get_arch(ARCH_ID)
        if reduce:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert bucket_floor(get_arch(ARCH_ID).reduced(), 64) == 8
    assert bucket_floor(get_arch(ARCH_ID), 2048) == 8


# ---------------------------------------------------------------------------
# mlstm_chunkwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,d,bq", [(2, 128, 32, 32), (1, 256, 64, 64),
                                       (4, 64, 16, 64), (3, 48, 32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_chunkwise_plain_matches_jax(bh, s, d, bq, dtype):
    """The TPU-signature entry and the plain version (fed the stable
    log-sigmoid) against the interpret-mode Pallas kernel at its block
    size ``bq`` and the strict per-step oracle."""
    rng = np.random.RandomState(bh * s + d)
    q, k, v, it, ft = _qkvif(rng, bh, s, d)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = dict(rtol=3e-3, atol=3e-3) if dtype == "float32" else \
        dict(rtol=5e-2, atol=5e-2)
    qt, kt, vt = (_t(x).to(tdt) for x in (q, k, v))
    got = ops.mlstm(qt, kt, vt, _t(it), _t(ft))
    plain, C, n, m = tref.mlstm_chunkwise_ref(qt, kt, vt, _t(it),
                                              log_sigmoid(_t(ft)))
    assert got.dtype == tdt and got.shape == (bh, s, d)
    assert (C.shape, n.shape, m.shape) == ((bh, d, d), (bh, d), (bh,))
    qj, kj, vj = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want_kernel = jops.mlstm(qj, kj, vj, jnp.asarray(it), jnp.asarray(ft), bq=bq)
    want_ref = jref.mlstm_ref(qj, kj, vj, jnp.asarray(it), jnp.asarray(ft))
    for out in (got, plain):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(out.float().numpy(),
                                       np.asarray(want, np.float32), **tol)


def test_mlstm_ref_matches_jax():
    rng = np.random.RandomState(12)
    q, k, v, it, ft = _qkvif(rng, 3, 40, 32)
    got = ops.mlstm_ref(*map(_t, (q, k, v, it, ft)))
    want = jref.mlstm_ref(*map(jnp.asarray, (q, k, v, it, ft)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_log_sigmoid_is_stable():
    x = torch.tensor([-1e4, -80.0, -3.0, 0.0, 3.0, 80.0, 1e4])
    got = log_sigmoid(x)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.nn.log_sigmoid(x.numpy())),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_fold_identity_tail_equals_prefix(with_state):
    """Identity gates (log f, i) = (0, -1e30) on the last 13 of 45 steps:
    the outputs before them and the final (C, n, m) equal a run on the
    30-step prefix, from zeros or from a nonzero state; the fold's state
    agrees with the JAX reference's ``_mlstm_suffix_state``."""
    rng = np.random.RandomState(13)
    bh, s, d, keep = 3, 45, 32, 32
    q, k, v, it, ft = map(_t, _qkvif(rng, bh, s, d))
    logf = log_sigmoid(ft)
    state = ()
    if with_state:
        state = (_t((0.3 * rng.standard_normal((bh, d, d))).astype(np.float32)),
                 _t((0.3 * rng.standard_normal((bh, d))).astype(np.float32)),
                 _t(rng.standard_normal(bh).astype(np.float32)))
    it_p, logf_p = it.clone(), logf.clone()
    it_p[:, keep:], logf_p[:, keep:] = _NEG, 0.0
    h, C, n, m = ops.mlstm_fold(q, k, v, it_p, logf_p, *state)
    h0, C0, n0, m0 = ops.mlstm_fold(q[:, :keep], k[:, :keep], v[:, :keep],
                                    it[:, :keep], logf[:, :keep], *state)
    np.testing.assert_allclose(h[:, :keep].numpy(), h0.numpy(), **TOL)
    for a, b in ((C, C0), (n, n0), (m, m0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    # the reference folds the whole prompt in one go
    st = {"C": jnp.asarray(state[0])[None] if state else
          jnp.zeros((1, bh, d, d), jnp.float32),
          "n": jnp.asarray(state[1])[None] if state else
          jnp.zeros((1, bh, d), jnp.float32),
          "m": jnp.asarray(state[2])[None] if state else
          jnp.full((1, bh), _NEG, jnp.float32)}

    def bshd(x):  # [BH, S, ...] -> [1, S, BH, ...]: heads = bh
        return jnp.asarray(x.numpy()).swapaxes(0, 1)[None]

    want = JR._mlstm_suffix_state(None, st, bshd(k), bshd(v), bshd(it_p),
                                  bshd(logf_p))
    for name, got in (("C", C), ("n", n), ("m", m)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name])[0],
                                   **TOL, err_msg=name)


def test_mlstm_fold_checks_its_operands():
    q = torch.zeros(2, 8, 32)
    gate = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        ops.mlstm_fold(q, q, q[:, :4], gate, gate)
    with pytest.raises(ValueError):
        ops.mlstm_fold(q, q, q, gate, gate, torch.zeros(2, 32, 32))
    with pytest.raises(TypeError):
        ops.mlstm_fold(q, q, q, gate.double(), gate)


# ---------------------------------------------------------------------------
# the two blocks
# ---------------------------------------------------------------------------

def _block_state(kind, rng, b, arch):
    if kind == "mlstm":
        hd = 2 * arch.d_model // arch.num_heads
        return {"C": (0.3 * rng.standard_normal((b, arch.num_heads, hd, hd))).astype(np.float32),
                "n": (0.3 * rng.standard_normal((b, arch.num_heads, hd))).astype(np.float32),
                "m": rng.standard_normal((b, arch.num_heads)).astype(np.float32)}
    d = arch.d_model
    return {"c": rng.standard_normal((b, d)).astype(np.float32),
            "n": rng.uniform(0.5, 2.0, (b, d)).astype(np.float32),
            "h": rng.standard_normal((b, d)).astype(np.float32),
            "m": rng.standard_normal((b, d)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_jax(pair, kind):
    """A padded prefill from a nonzero state (rows of full, partial and
    one-step length), then two decode steps: outputs at valid positions
    and every state leaf, at 2e-4."""
    arch_j, params, arch, _, model = pair
    j = 0 if kind == "mlstm" else 1
    p = jax.tree.map(lambda x: x[0], params["body"][f"b{j}_{kind}"])
    layer = model.layers[j]
    apply = JR.mlstm_apply if kind == "mlstm" else JR.slstm_apply
    rng = np.random.RandomState(14 + j)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    lens = np.array([16, 9, 1], np.int32)
    st = _block_state(kind, rng, 3, arch)
    yj, sj = apply(arch_j, p, jnp.asarray(x), state=jax.tree.map(jnp.asarray, st),
                   seq_lens=jnp.asarray(lens))
    yt, s_t = layer(_t(x), state={k: _t(v) for k, v in st.items()},
                    seq_lens=_t(lens))
    for i, s in enumerate(lens):
        np.testing.assert_allclose(yt[i, :s].numpy(), np.asarray(yj)[i, :s], **TOL)
    assert set(s_t) == set(sj)
    for k in sj:
        assert s_t[k].dtype == torch.float32
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(sj[k]), **TOL,
                                   err_msg=k)
    decode_j = jax.jit(lambda x_, s_: apply(arch_j, p, x_, state=s_))
    for step in range(2):
        xt = rng.standard_normal((3, 1, 64)).astype(np.float32)
        yj, sj = decode_j(jnp.asarray(xt), sj)
        yt, s_t = layer(_t(xt), state=s_t)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        for k in sj:
            np.testing.assert_allclose(s_t[k].numpy(), np.asarray(sj[k]), **TOL,
                                       err_msg=f"decode {step} {k}")
    # without a state: a full forward from zeros, no state returned
    yj, _ = apply(arch_j, p, jnp.asarray(x))
    yt, none = layer(_t(x))
    assert none is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_bridge_maps_the_body(pair):
    arch_j, params, arch, tree, model = pair
    assert model.kinds == ["mlstm", "slstm", "mlstm", "slstm"]
    assert set(tree["body"]) == {"b0_mlstm", "b1_slstm"}
    for r in range(2):
        for j, kind in enumerate(("mlstm", "slstm")):
            layer = model.layers[2 * r + j]
            names = dict(layer.named_parameters())
            assert set(names) == set(tree["body"][f"b{j}_{kind}"])
            for name, leaf in names.items():
                np.testing.assert_array_equal(
                    leaf.numpy(), tree["body"][f"b{j}_{kind}"][name][r])
    for bad in ("suffix", "leaf", "repeats"):
        broken = jax.tree.map(lambda x: x, tree)
        if bad == "suffix":
            broken["suffix0"] = jax.tree.map(lambda x: x[0], tree["body"]["b0_mlstm"])
        elif bad == "leaf":
            broken["body"] = dict(tree["body"], b1_slstm=dict(
                tree["body"]["b1_slstm"], extra=np.zeros((2, 3), np.float32)))
        else:
            broken["body"] = jax.tree.map(lambda x: x[:1], tree["body"])
        with pytest.raises((KeyError, ValueError)):
            bridge.from_jax_params(broken, arch, device="cpu")


def test_init_params_draws_xlstm_init_distributions():
    arch = get_arch(ARCH_ID).reduced()
    a = REG.init_params(arch, 3, device="cpu")
    b = REG.init_params(arch, 3, device="cpu")
    assert a.kinds == ["mlstm", "slstm", "mlstm", "slstm"]
    torch.testing.assert_close(a.layers[1].r, b.layers[1].r, rtol=0, atol=0)
    ml, sl = a.layers[0], a.layers[1]
    d, w, hd = arch.d_model, 2 * arch.d_model, arch.d_model // arch.num_heads
    assert tuple(ml.w_up.shape) == (d, 2 * w) and tuple(ml.w_i.shape) == (w, 4)
    assert tuple(sl.r.shape) == (arch.num_heads, hd, 4 * hd)
    assert torch.equal(ml.b_f, torch.full((arch.num_heads,), 3.0))
    for t in (ml.ln1, ml.ln_inner, ml.b_i, sl.ln1, sl.b):
        assert float(t.abs().max()) == 0.0
    for p, fan_in in ((ml.w_up, d), (ml.wq, w), (ml.w_f, w), (ml.w_down, w),
                      (sl.w, d), (sl.r, hd), (sl.w_out, d)):
        assert float(p.abs().max()) <= 2.0 / math.sqrt(fan_in) + 1e-6
        assert float(p.std()) > 0.5 / math.sqrt(fan_in)
    n = sum(p.numel() for p in a.parameters())
    jn = sum(x.size for x in jax.tree.leaves(jax.eval_shape(
        lambda: JREG.init_params(jax_get_arch(ARCH_ID).reduced(),
                                 jax.random.PRNGKey(0), jnp.float32))))
    assert n == jn


def test_forward_with_caches_matches_jax_leaf_by_leaf(pair):
    """A padded batched prefill into fresh states of the same padded
    length on both sides, then decode steps: hidden states, logits and
    every state leaf of every layer."""
    arch_j, params, arch, _, model = pair
    n, bucket = 3, 32
    lens = np.array([5, 32, 20], np.int32)
    toks = _tokens(lens, bucket, seed=16)
    h_j, c_j = JLM.forward(arch_j, params, jnp.asarray(toks),
                           caches=JREG.make_caches(arch_j, n, bucket, jnp.float32),
                           seq_lens=jnp.asarray(lens))
    h_t, c_t = model(_t(toks), caches=model.make_caches(n, bucket),
                     seq_lens=_t(lens))
    for i, s in enumerate(lens):
        np.testing.assert_allclose(h_t[i, :s].numpy(), np.asarray(h_j)[i, :s], **TOL)

    def check():
        for i, kind in enumerate(model.kinds):
            cj = c_j["body"][f"b{i % 2}_{kind}"]
            assert set(c_t[i]) == set(cj)
            for k, leaf in c_t[i].items():
                assert leaf.dtype == torch.float32
                np.testing.assert_allclose(leaf.numpy(), np.asarray(cj[k])[i // 2],
                                           **TOL, err_msg=f"layer {i} {k}")

    check()
    decode_j = jax.jit(lambda p, t, c, q: JLM.forward(arch_j, p, t, caches=c,
                                                      positions=q))
    rng = np.random.RandomState(17)
    pos = lens.copy()
    for _ in range(4):
        tok = rng.randint(1, 256, size=(n, 1)).astype(np.int32)
        h_j, c_j = decode_j(params, jnp.asarray(tok), c_j, jnp.asarray(pos[:, None]))
        h_t, c_t = model(_t(tok), caches=c_t, positions=_t(pos[:, None]))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
        np.testing.assert_allclose(
            model.logits(h_t).numpy(),
            np.asarray(JLM.logits_fn(arch_j, params, h_j)), **TOL)
        pos += 1
        check()


def test_prefill_state_is_bit_equal_across_buckets(pair):
    """The same prompts padded to 16 and to 32 give bit-equal mLSTM and
    sLSTM states and logits: padded steps are exact identities in the
    port's chunked fold (chunks of 16) and the sLSTM mask-carry."""
    _, _, _, _, model = pair
    lens = np.array([5, 16, 11], np.int32)
    out = {}
    for bucket in (16, 32):
        out[bucket] = prefill_rows(model, _t(_tokens(lens, bucket, seed=18)),
                                   _t(lens))
    (r16, l16), (r32, l32) = out[16], out[32]
    for a, b in zip(r16, r32):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(l16, l32)


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
    if scenario == "basic":  # live streams
        assert any(len(set(t)) > 4 for t in got.values()), got


_QSTREAMS = {}


@pytest.mark.parametrize("lookahead", [0, 1])
def test_ssm_int8_serving_raises(pair, lookahead):
    """INT8 serving of the ssm family (it raised before the family's
    leaves were quantised by the reference's stack structure): under
    ``INT8_SERVE`` the streams equal the JAX quantised engine's, the
    mLSTM and sLSTM recurrences in fp32 on int8 weights; a flip only as
    a near-tie. ``QuantConfig(kv="int8")`` alone serves as the fp engine
    does: the family holds no KV cache."""
    from repro import quant as JQ
    from repro_torch.quant import INT8_SERVE, QuantConfig
    arch_j, params, arch, tree, _ = pair
    prompts, slots = _scenario("basic")
    if "int8" not in _QSTREAMS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jeng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                  config=JServeConfig(
                                      slots=slots, max_len=MAX_LEN,
                                      quant=JQ.INT8_SERVE))
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        jeng.run_until_drained(max_steps=2000)
        _QSTREAMS["int8"] = {r.rid: list(r.out_tokens) for r in jeng.completed}
    want = _QSTREAMS["int8"]
    streams = {}
    for quant in (INT8_SERVE, QuantConfig(kv="int8")):
        model = bridge.from_jax_params(tree, arch, device="cpu")
        eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
            slots=slots, max_len=MAX_LEN, lookahead=lookahead, quant=quant))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=2000)
        streams[quant] = {r.rid: list(r.out_tokens) for r in eng.completed}
        assert model.weights_quantized == quant.quant_weights
        if quant is INT8_SERVE:
            faults, ties = _flips(model, prompts, streams[quant], want)
            assert not faults, faults
            if ties:
                warnings.warn(f"near-tie flips: {ties}")
    assert any(len(set(t)) > 4 for t in streams[INT8_SERVE].values())
    _, _, fp = _port_streams(pair, "basic", lookahead)
    assert streams[QuantConfig(kv="int8")] == fp


def test_serve_launcher_runs_xlstm_on_cpu(capsys):
    from repro_torch.launch import serve
    engine = serve.main(["--arch", ARCH_ID, "--device", "cpu", "--requests", "3",
                         "--slots", "2", "--max-len", "48", "--new-tokens", "20"])
    assert len(engine.completed) == 3
    assert all(len(r.out_tokens) == 20 for r in engine.completed)
    assert "xlstm-350m-smoke" in capsys.readouterr().out
