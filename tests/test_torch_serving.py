"""Greedy streams of the port's ``ServingEngine(device="cpu")`` vs the JAX
package's frozen ``ReferenceEngine`` on the same (bridged) weights.

Scenarios follow ``repro.testing.serving_equiv``: ``basic`` (every
request admitted at once), ``churn`` (more requests than slots, finished
slots re-admit mid-stream) and ``eos`` (an EOS id that fires, including
straight out of prefill). Each runs at lookahead 0 and 1. The reference
pads every prompt to ``max_len`` and masks it; the port buckets prompts
to powers of two and prefills a bucket's requests as one batch. On a
divergence the failure names the top-2 logit margin of the port's model
at the diverging position (a flip under the fp32 tolerance is a
near-tie, not a fault).

INT8 (``ServeConfig(quant=INT8_SERVE)``): the port's streams equal the
JAX package's unplanned dense quantised ``ServingEngine`` (the golden of
``serving_equiv.check_quant_equivalence``) token for token, in the same
scenarios, on a tree with seeded norms and biases and scaled-up output
projections so that the greedy streams do not just repeat their last
prompt token. The port's INT8 prefill logits stay within
``QUANT_LOGITS_TOL`` of its fp32 logits (``_quant_logits_probe``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.configs import get_arch as jax_get_arch
from repro.models import registry as JREG
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import (QUANT_LOGITS_TOL, ReferenceEngine,
                                         _prompts)
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.quant import INT8_SERVE
from repro_torch.serving import (IncompleteDrainError, Request,
                                 RequestValidationError, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.scheduler import prefill_rows

ARCH_ID = "qwen1.5-0.5b"
SLOTS, MAX_LEN, MAX_NEW, SEED = 4, 32, 6, 0


@pytest.fixture(scope="module")
def setup():
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    params = JREG.init_params(arch_j, jax.random.PRNGKey(SEED), jnp.float32)
    tree = jax.tree.map(np.asarray, params)
    return arch_j, params, arch, tree


def _scenario(name):
    """(prompts, slots, eos candidates or None) per scenario."""
    arch = jax_get_arch(ARCH_ID).reduced()
    if name == "basic":
        return _prompts(arch, SLOTS, MAX_LEN, SEED, MAX_NEW), SLOTS
    if name == "churn":
        n_slots = max(SLOTS // 2, 1)
        return (_prompts(arch, int(n_slots * 2.5) + 1, MAX_LEN, SEED + 1,
                         MAX_NEW), n_slots)
    return _prompts(arch, 2, MAX_LEN, SEED + 2, MAX_NEW), 2


_REF_CACHE = {}


def _reference(setup, name, eos_id=None):
    key = (name, eos_id)
    if key not in _REF_CACHE:
        arch_j, params, _, _ = setup
        prompts, slots = _scenario(name)
        eng = ReferenceEngine(arch_j, params, slots=slots, max_len=MAX_LEN,
                              eos_id=eos_id, dtype=jnp.float32)
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=4000)
        _REF_CACHE[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _REF_CACHE[key]


def _port(setup, name, lookahead, eos_id=None):
    _, _, arch, tree = setup
    prompts, slots = _scenario(name)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, eos_id=eos_id, lookahead=lookahead))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=4000)
    return model, prompts, eng, {r.rid: list(r.out_tokens) for r in eng.completed}


def _margin(model, prompt, prefix) -> float:
    """Top-2 logit margin of the port's model at the next position after
    ``prompt + prefix`` (one full causal forward, no cache)."""
    toks = torch.from_numpy(np.concatenate([prompt, np.asarray(prefix, np.int32)])
                            .astype(np.int32))[None]
    hidden, _ = model(toks)
    top = torch.topk(model.logits(hidden[:, -1]).float(), 2).values[0]
    return float(top[0] - top[1])


def _diff(model, prompts, got, want):
    bad = []
    for rid in sorted(want):
        g, w = got.get(rid), want[rid]
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g or [], w)) if a != b),
                 min(len(g or []), len(w)))
        margin = _margin(model, prompts[rid], w[:j])
        bad.append(f"rid={rid}: port={g} ref={w} (first diff at {j}, "
                   f"top-2 margin {margin:.3e})")
    if set(got) != set(want):
        bad.append(f"completed sets differ: {sorted(got)} vs {sorted(want)}")
    return bad


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("scenario", ["basic", "churn"])
def test_greedy_streams_match_reference(setup, scenario, lookahead):
    want = _reference(setup, scenario)
    model, prompts, eng, got = _port(setup, scenario, lookahead)
    assert not _diff(model, prompts, got, want), _diff(model, prompts, got, want)
    assert not any(ops.launch_counts().values())  # CPU: plain versions
    if scenario == "churn":
        assert len(prompts) > eng.slots


@pytest.mark.parametrize("lookahead", [0, 1])
def test_greedy_streams_match_reference_with_eos(setup, lookahead):
    probe = _reference(setup, "eos")
    candidates = {probe[0][0]}  # EOS straight out of prefill for request 0
    candidates.update(t for toks in probe.values() for t in toks[1:])
    for eos in sorted(candidates)[:2]:
        want = _reference(setup, "eos", eos_id=int(eos))
        model, prompts, _, got = _port(setup, "eos", lookahead, eos_id=int(eos))
        bad = _diff(model, prompts, got, want)
        assert not bad, f"eos={eos}: {bad}"


def test_engine_stats_and_validation(setup):
    _, _, arch, tree = setup
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu",
                        config=ServeConfig(slots=2, max_len=16))
    with pytest.raises(RequestValidationError):
        eng.submit(Request(rid=0, prompt=np.ones(12, np.int32),
                           max_new_tokens=8))
    for rid, n in enumerate((3, 9, 5)):
        eng.submit(Request(rid=rid, prompt=np.arange(1, n + 1, dtype=np.int32),
                           max_new_tokens=4))
    steps = eng.run_until_drained()
    stats, pstats = eng.step_stats(), eng.prefill_stats()
    assert stats["steps"] == steps and stats["tokens"] == 12
    assert pstats["prefills"] == 3 and pstats["prompt_tokens"] == 17
    assert sorted(r.rid for r in eng.completed) == [0, 1, 2]


def test_run_until_drained_raises_with_unfinished_rids(setup):
    _, _, arch, tree = setup
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu",
                        config=ServeConfig(slots=1, max_len=32))
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=np.ones(4, np.int32),
                           max_new_tokens=8))
    with pytest.raises(IncompleteDrainError) as exc:
        eng.run_until_drained(max_steps=3)
    assert sorted(exc.value.unfinished) == [0, 1]
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        eng.run_until_drained(max_steps=1, on_incomplete="warn")


def test_unported_options_raise(setup):
    from repro_torch.serving import PagingConfig, SamplingParams
    _, _, arch, tree = setup
    model = bridge.from_jax_params(tree, arch, device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(arch, model, device="cpu", config=ServeConfig(
            slots=2, max_len=16, paging=PagingConfig(paged=True)))
    with pytest.raises(NotImplementedError):
        ServingEngine(arch, model, device="cpu", config=ServeConfig(
            slots=2, max_len=16,
            sampling=SamplingParams(method="temperature", temperature=0.7)))


# ---------------------------------------------------------------------------
# INT8 serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qsetup(setup):
    arch_j, _, arch, tree = setup
    rng = np.random.RandomState(SEED + 1)
    tree = jax.tree.map(lambda x: x, tree)
    body = dict(tree["body"]["b0_attn"])
    for name in ("ln1", "ln2", "bq", "bk", "bv"):
        body[name] = (0.5 * rng.standard_normal(body[name].shape)).astype(np.float32)
    body["wo"] = body["wo"] * 8.0
    body["mlp"] = {k: v * 8.0 for k, v in body["mlp"].items()}
    tree["body"] = {"b0_attn": body}
    return arch_j, jax.tree.map(jnp.asarray, tree), arch, tree


_QREF_CACHE = {}


def _jax_int8(qsetup, name, eos_id=None):
    """Streams of the JAX unplanned dense engine under INT8_SERVE."""
    key = (name, eos_id)
    if key not in _QREF_CACHE:
        arch_j, params, _, _ = qsetup
        prompts, slots = _scenario(name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                 config=JServeConfig(slots=slots,
                                                     max_len=MAX_LEN,
                                                     eos_id=eos_id,
                                                     quant=JQ.INT8_SERVE))
        for i, p in enumerate(prompts):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained(max_steps=4000)
        _QREF_CACHE[key] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _QREF_CACHE[key]


def _port_int8(qsetup, name, lookahead, eos_id=None):
    _, _, arch, tree = qsetup
    prompts, slots = _scenario(name)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, eos_id=eos_id, lookahead=lookahead,
        quant=INT8_SERVE))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=4000)
    return model, prompts, eng, {r.rid: list(r.out_tokens) for r in eng.completed}


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("scenario", ["basic", "churn", "eos"])
def test_int8_greedy_streams_match_jax_engine(qsetup, scenario, lookahead):
    eos_ids = [None]
    if scenario == "eos":  # EOS straight out of prefill, and mid-stream
        probe = _jax_int8(qsetup, "eos")
        eos_ids = [probe[0][0], probe[1][2]]
    for eos in eos_ids:
        want = _jax_int8(qsetup, scenario, eos_id=eos)
        model, prompts, eng, got = _port_int8(qsetup, scenario, lookahead,
                                              eos_id=eos)
        bad = _diff(model, prompts, got, want)
        assert not bad, f"eos={eos}: {bad}"
        assert model.weights_quantized
        assert eng.caches[0]["k"].dtype == torch.int8
    if scenario == "basic":  # the streams are not a repeated token
        assert any(len(set(toks)) > 2 for toks in want.values()), want
    if scenario == "eos":
        assert any(len(t) < MAX_NEW for t in want.values()), want
    assert not any(ops.launch_counts().values())


def test_int8_logits_stay_within_quant_tolerance_of_fp32(qsetup):
    """``serving_equiv._quant_logits_probe`` on the port: the same
    length-exact prefill with fp32 params and grid, then with int8
    weights and an int8 grid."""
    _, _, arch, tree = qsetup
    prompt = _prompts(jax_get_arch(ARCH_ID).reduced(), 1, MAX_LEN, SEED + 5,
                      MAX_NEW)[0]
    toks = np.zeros((1, MAX_LEN), np.int32)
    toks[0, :len(prompt)] = prompt
    lens = torch.tensor([len(prompt)], dtype=torch.int32)
    fp_model = bridge.from_jax_params(tree, arch, device="cpu")
    _, lf = prefill_rows(fp_model, torch.from_numpy(toks), lens)
    q_model = bridge.from_jax_params(tree, arch, device="cpu")
    from repro_torch.quant import quantize_params
    _, lq = prefill_rows(quantize_params(q_model), torch.from_numpy(toks), lens,
                         kv_quant=True)
    lf, lq = lf.double(), lq.double()
    err = float((lq - lf).abs().max() / max(1.0, float(lf.abs().max())))
    assert 0 < err <= QUANT_LOGITS_TOL, err


def test_int8_weights_only_and_kv_only_serve_on_cpu(qsetup):
    """The two halves of INT8_SERVE alone: weights-only keeps an fp32
    grid, kv-only keeps fp params with an int8 grid; both drain."""
    from repro_torch.quant import QuantConfig
    _, _, arch, tree = qsetup
    prompts, slots = _scenario("basic")
    for quant in (QuantConfig(weights="int8"), QuantConfig(kv="int8")):
        model = bridge.from_jax_params(tree, arch, device="cpu")
        eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
            slots=slots, max_len=MAX_LEN, quant=quant))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_until_drained()
        assert len(eng.completed) == len(prompts)
        assert model.weights_quantized == quant.quant_weights
        assert (eng.caches[0]["k"].dtype == torch.int8) == quant.quant_kv
