"""Seeded temperature / top-k sampling of the port (``serving/sampler.py``)
against the JAX package's, on the CPU.

The port computes JAX's own threefry-2x32 words with torch integer ops,
so the keys are held bit-equal to ``jax.random``'s (``PRNGKey``,
``fold_in``, the partitionable ``split`` and ``bits``), the Gumbel noise
to the last place of ``log``, and the drawn tokens equal to
``repro.serving.sampler.sample``'s, ties in top-k included (exactly k
candidates, lowest index first). The sampled streams of the port's
``ServingEngine`` equal the JAX ``ServingEngine``'s token for token
(qwen1.5-0.5b on the grid and the paged pool at lookahead 0 and 1,
recurrentgemma-2b and xlstm-350m once each), and at lookahead 0, where
both engines take the same steps, every slot's key equals JAX's after
every step. A stream that differs names the top-2 margin of ``logits / T
+ gumbel`` where it parts (a near-tie under 2e-4 may flip on the two
``log`` implementations; none does here).
"""
import sys
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
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
from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                 ServeConfig, ServingEngine)
from repro_torch.serving import sampler as S

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_step_graph import _liven  # noqa: E402

SEED, SLOTS, N_REQ, MAX_LEN, MAX_NEW, PS = 0, 2, 5, 48, 8, 8
#: a flip of a sampled token is a near-tie below this top-2 margin of
#: ``logits / T + gumbel`` (fp32 ``log`` of XLA and of PyTorch)
MARGIN_TOL = 2e-4
METHODS = {"temperature": SamplingParams("temperature", 0.8),
           "top_k": SamplingParams("top_k", 0.8, 5)}


def _jax_key(seed, *fold):
    key = jax.random.PRNGKey(seed)
    for d in fold:
        key = jax.random.fold_in(key, d)
    return key


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, 123456, 2 ** 31 + 5])
def test_keys_equal_jax_fold_in_and_split_chain(seed):
    rids = torch.tensor([0, 1, 5, 4096])
    got = S.fold_in(S.prng_key(seed), rids)
    want = np.stack([_np(_jax_key(seed, int(r))) for r in rids])
    assert np.array_equal(got.numpy(), want)
    keys_j = jnp.asarray(want.astype(np.uint32))
    with jax.threefry_partitionable(True):
        for _ in range(4):  # carried halves and drawn halves
            pair = jax.vmap(jax.random.split)(keys_j)
            got, sub = S.split(got)
            assert np.array_equal(got.numpy(), _np(pair[:, 0]))
            assert np.array_equal(sub.numpy(), _np(pair[:, 1]))
            keys_j = pair[:, 0]


def test_bits_and_gumbel_equal_jax():
    keys = np.stack([_np(_jax_key(s, r)) for s, r in ((0, 3), (9, 1))])
    n = 3001
    with jax.threefry_partitionable(True):
        bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k.astype(np.uint32)),
                                                    (n,), jnp.uint32))
                         for k in keys])
        gum = np.stack([np.asarray(jax.random.gumbel(
            jnp.asarray(k.astype(np.uint32)), (n,), jnp.float32)) for k in keys])
    got_bits = S.random_bits(torch.from_numpy(keys), n).numpy()
    assert np.array_equal(got_bits, bits.astype(np.int64))
    got = S.gumbel(torch.from_numpy(keys), n).numpy()
    np.testing.assert_allclose(got, gum, rtol=2e-6, atol=2e-6)  # log's last place


def _tied_logits(rng, rows, v):
    x = (3.0 * rng.standard_normal((rows, v))).astype(np.float32)
    x[0, :] = 1.0                       # every entry tied
    x[1, 7:20] = x[1].max() + 1.0       # 13 tied at the top
    x[2, ::3] = 0.5                     # a tie across the k-th value
    x[3] = np.round(x[3])               # many small ties
    return x


@pytest.mark.parametrize("method,temperature,k", [
    ("greedy", 1.0, 0), ("temperature", 0.7, 0), ("top_k", 1.0, 1),
    ("top_k", 0.9, 3), ("top_k", 0.7, 50)])
def test_sample_equals_jax_sample(method, temperature, k):
    rng = np.random.RandomState(1)
    v = 1000
    keys = np.stack([_np(_jax_key(s, r)) for s, r in
                     ((0, 1), (1, 2), (3, 4), (5, 6), (8, 8), (9, 9))])
    keys_j, keys_t = jnp.asarray(keys.astype(np.uint32)), torch.from_numpy(keys)
    sp_j = JS.SamplingParams(method, temperature, k)
    sp_t = SamplingParams(method, temperature, k)
    for _ in range(5):  # a chain of steps, keys carried
        logits = _tied_logits(rng, len(keys), v)
        keys_j, tok_j = JS.sample(jnp.asarray(logits), keys_j, sp_j)
        keys_t, tok_t = S.sample(torch.from_numpy(logits), keys_t, sp_t)
        assert np.array_equal(_np(keys_j), keys_t.numpy())
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
    if method == "greedy":
        assert keys_t is not None and np.array_equal(keys_t.numpy(), keys)


@pytest.mark.parametrize("k", [1, 3, 13, 14, 50])
def test_top_k_keeps_exactly_k_lowest_index_first(k):
    rng = np.random.RandomState(2)
    row = torch.from_numpy(_tied_logits(rng, 4, 300)) / 0.7
    kept = torch.isfinite(S.top_k_mask(row, k))
    assert kept.sum(dim=-1).tolist() == [k] * 4
    assert kept[0].nonzero().flatten().tolist() == list(range(k))
    for r in range(4):  # the same set as lax.top_k's indices
        _, idx = jax.lax.top_k(jnp.asarray(row[r].numpy()), k)
        assert sorted(np.asarray(idx).tolist()) == \
            kept[r].nonzero().flatten().tolist()


# ---------------------------------------------------------------------------
# sampled streams against the JAX ServingEngine
# ---------------------------------------------------------------------------

_TREES = {}


def _tree(arch_id):
    if arch_id not in _TREES:
        arch_j = jax_get_arch(arch_id).reduced()
        _TREES[arch_id] = _liven(jax.tree.map(np.asarray, JREG.init_params(
            arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
    return _TREES[arch_id]


def _prompts_for(arch_id):
    return _prompts(jax_get_arch(arch_id).reduced(), N_REQ, MAX_LEN, SEED + 1,
                    MAX_NEW)


def _jsp(sp):
    return JS.SamplingParams(sp.method, sp.temperature, sp.top_k)


def _jax_engine(arch_id, sp, paged, lookahead):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return JServingEngine(
            jax_get_arch(arch_id).reduced(),
            jax.tree.map(jnp.asarray, _tree(arch_id)), dtype=jnp.float32,
            config=JServeConfig(slots=SLOTS, max_len=MAX_LEN, seed=SEED,
                                lookahead=lookahead, sampling=_jsp(sp),
                                paging=JPagingConfig(paged=paged,
                                                     page_size=PS)))


def _port_engine(arch_id, sp, paged, lookahead):
    arch = get_arch(arch_id).reduced()
    model = bridge.from_jax_params(_tree(arch_id), arch, device="cpu")
    return ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, seed=SEED, lookahead=lookahead,
        sampling=sp, paging=PagingConfig(paged=paged, page_size=PS)))


def sample_margin(model, prompt, prefix, rid, sp, seed=SEED) -> float:
    """Top-2 margin of ``logits / T + gumbel`` (top-k masked) of the draw
    that gave token ``len(prefix)`` of request ``rid``: its key is the
    request's ``fold_in(PRNGKey(seed), rid)`` carried through one split
    per token before it, then split once more for the draw."""
    toks = np.concatenate([prompt, np.asarray(prefix, np.int32)])
    hidden, _ = model(torch.from_numpy(toks.astype(np.int32))[None])
    row = model.logits(hidden[:, -1]).float() / sp.temperature
    if sp.method == "top_k":
        row = S.top_k_mask(row, sp.top_k)
    key = S.fold_in(S.prng_key(seed), torch.tensor([rid]))
    for _ in prefix:
        key = S.split(key)[0]
    z = row + S.gumbel(S.split(key)[1], row.shape[-1])
    top = torch.topk(z[0], 2).values
    return float(top[0] - top[1])


def stream_diff(model, prompts, got, want, sp):
    bad = []
    for rid in sorted(want):
        g, w = got.get(rid) or [], want[rid]
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        margin = sample_margin(model, prompts[rid], w[:j], rid, sp)
        if margin >= MARGIN_TOL:
            bad.append(f"rid={rid}: port={g} jax={w} (first diff at {j}, "
                       f"top-2 margin of logits/T + gumbel {margin:.3e})")
        else:
            warnings.warn(f"rid={rid}: near-tie flip at {j} (margin "
                          f"{margin:.3e})")
    if set(got) != set(want):
        bad.append(f"completed sets differ: {sorted(got)} vs {sorted(want)}")
    return bad


_JAX_STREAMS = {}


def _jax_streams(arch_id, method, paged):
    """The JAX engine's streams, at lookahead 0 (a sampled stream does not
    depend on the lookahead: each request draws with its own key), and
    its slot keys after every step."""
    key = (arch_id, method, paged)
    if key not in _JAX_STREAMS:
        eng = _jax_engine(arch_id, METHODS[method], paged, 0)
        for i, p in enumerate(_prompts_for(arch_id)):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW))
        keys = []
        while eng.queue or eng.scheduler.has_active():
            eng.step()
            keys.append(_np(eng.state.rng))
        _JAX_STREAMS[key] = ({r.rid: list(r.out_tokens) for r in eng.completed},
                             keys)
    return _JAX_STREAMS[key]


def _run_port(arch_id, method, paged, lookahead):
    eng = _port_engine(arch_id, METHODS[method], paged, lookahead)
    prompts = _prompts_for(arch_id)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    keys = []
    while eng.queue or eng.scheduler.has_active():
        eng.step()
        keys.append(eng.state.rng.numpy().copy())
    eng._flush()
    return eng, prompts, {r.rid: list(r.out_tokens) for r in eng.completed}, keys


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("method", list(METHODS))
def test_sampled_streams_equal_jax_engine(method, paged, lookahead):
    arch_id = "qwen1.5-0.5b"
    want, want_keys = _jax_streams(arch_id, method, paged)
    eng, prompts, got, keys = _run_port(arch_id, method, paged, lookahead)
    bad = stream_diff(eng.model, prompts, got, want, METHODS[method])
    assert not bad, bad
    assert all(len(t) == MAX_NEW for t in got.values())
    assert any(len(set(t)) > 2 for t in got.values()), got
    if lookahead == 0:  # the same steps: every slot key after every step
        assert len(keys) == len(want_keys)
        for n, (g, w) in enumerate(zip(keys, want_keys)):
            assert np.array_equal(g, w), f"slot keys differ after step {n}"


@pytest.mark.parametrize("arch_id,method", [("recurrentgemma-2b", "top_k"),
                                            ("xlstm-350m", "temperature")])
def test_sampled_streams_equal_jax_engine_other_families(arch_id, method):
    want, want_keys = _jax_streams(arch_id, method, False)
    eng, prompts, got, keys = _run_port(arch_id, method, False, 0)
    bad = stream_diff(eng.model, prompts, got, want, METHODS[method])
    assert not bad, bad
    assert len(keys) == len(want_keys)
    assert np.array_equal(keys[-1], want_keys[-1])


def test_greedy_engine_keeps_its_admission_keys():
    """Greedy draws nothing: after a drain each slot holds the key of the
    last request admitted there, ``fold_in(PRNGKey(seed), rid)``."""
    eng = _port_engine("qwen1.5-0.5b", SamplingParams(), False, 0)
    for i, p in enumerate(_prompts_for("qwen1.5-0.5b")[:SLOTS]):
        eng.submit(Request(rid=10 + i, prompt=p, max_new_tokens=3))
    eng.run_until_drained()
    want = np.stack([_np(_jax_key(SEED, 10 + i)) for i in range(SLOTS)])
    assert np.array_equal(eng.state.rng.numpy(), want)
