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
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import registry as JREG
from repro.serving.engine import Request as JRequest
from repro.testing.serving_equiv import ReferenceEngine, _prompts
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.serving import (IncompleteDrainError, Request,
                                 RequestValidationError, ServeConfig,
                                 ServingEngine)

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
    assert ops.launch_counts() == {"xfer_matmul": 0, "flash_attention": 0,
                                   "paged_attention": 0}  # CPU: plain versions
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
