"""Speculative decoding of the port (``registry._build_spec_serve_step``,
``ServeConfig(spec=SpecConfig(...))``) against the JAX package, on the
CPU.

* The S-query attention of the verify: the port's ``AttnBlock`` in
  append mode (``blocks._cache_write_many`` on the dense grid, S >= 1
  pool writes through the page table, and ``paged_attention``'s
  multi-query form, whose plain version ``ref.paged_attention_ref`` runs
  here) against the JAX ``attn_apply(append=True)`` gather path, on the
  grid and on the pool, with positions past the grid, past the table
  and past a row's reserved pages, at 2e-4 (fp32).
* Streams: the port's spec engine equals the JAX spec engine (the same
  bridged ``{"target", "draft"}`` pair) and the port's target-only
  engine, token for token, on the grid and the pool, k in {1, 3}, with a
  self-draft (every proposal accepted: ``draft_acceptance > 0.99``,
  ``accepted_tokens_mean > 1``, as ``tests/test_serving.py``'s spec
  test), a cold 1-layer draft (rejections) and top-k sampling; the
  acceptance counters ``accepted``/``proposed`` and the slot keys equal
  JAX's.
* INT8 (``INT8_SERVE``, the target quantised, the draft fp): the int8
  multi-query form's plain version is one query per position; streams
  and the acceptance counters equal the JAX quantised spec engine's on
  the grid and the pool.
* The pairing rules.
"""
import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import blocks as JB
from repro.models import registry as JREG
from repro.serving import sampler as JS
from repro.serving.config import PagingConfig as JPagingConfig
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.config import SpecConfig as JSpecConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import _prompts
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                 ServeConfig, ServingEngine, SpecConfig)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sampling import stream_diff  # noqa: E402
from test_torch_step_graph import _liven  # noqa: E402

ARCH_ID = "qwen1.5-0.5b"
SEED, SLOTS, N_REQ, MAX_LEN, MAX_NEW, PS = 0, 2, 5, 48, 8, 8
TOL = 2e-4


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


# ---------------------------------------------------------------------------
# the verify's S-query attention against the JAX gather path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    tree = _liven(jax.tree.map(np.asarray, JREG.init_params(
        arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    p_j = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["body"]["b0_attn"])
    return arch_j, arch, p_j, model.layers[0]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL, f"{what}: rel err {err:.3e} > {TOL}"


# (first positions per row, S); T = 16: rows ending past the grid
GRID_CASES = [([3, 9, 12], 4), ([15, 0, 14], 4), ([6, 13, 1], 2),
              ([2, 7, 15], 1)]


@pytest.mark.parametrize("firsts,s", GRID_CASES)
def test_append_on_the_grid_equals_jax(block, firsts, s):
    arch_j, arch, p_j, blk = block
    rng = np.random.RandomState(len(firsts) * 10 + s)
    b, t, g, d = len(firsts), 16, arch.num_kv_heads, arch.head_dim
    first = np.asarray(firsts, np.int32)
    positions = first[:, None] + np.arange(s, dtype=np.int32)[None]
    k = rng.standard_normal((b, t, g, d)).astype(np.float32)
    v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    pos = np.where(np.arange(t)[None] < first[:, None], np.arange(t)[None],
                   -1).astype(np.int32)
    x = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
    out_j, cache_j = JB.attn_apply(
        arch_j, p_j, jnp.asarray(x), positions=jnp.asarray(positions),
        cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
               "pos": jnp.asarray(pos), "count": jnp.asarray(0, jnp.int32)},
        append=True)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
             "pos": torch.from_numpy(pos.copy())}
    meta = (torch.arange(b, dtype=torch.int32)[:, None],
            torch.clamp(torch.from_numpy(first) + 1, max=t).to(torch.int32))
    with torch.no_grad():
        out, new = blk(torch.from_numpy(x), positions=torch.from_numpy(positions),
                       cache=cache, decode_meta=meta, append=True)
    assert new is cache  # written in place
    _close(out.numpy(), out_j, "block output")
    for name in ("k", "v"):
        _close(cache[name].numpy(), cache_j[name], f"grid {name}")
    assert np.array_equal(cache["pos"].numpy(), np.asarray(cache_j["pos"]))


# (first positions, reserved pages per row, S): pages of 8, a table of 4
# pages (t = 32); one row at a time crosses into the null page (past the
# table or past its reserved pages), so no two rows write one null slot
POOL_CASES = [([29, 5], [4, 2], 4), ([12, 30], [2, 4], 4),
              ([0, 21], [1, 3], 2), ([28, 7], [4, 1], 3)]


@pytest.mark.parametrize("firsts,reserved,s", POOL_CASES)
def test_append_on_the_pool_equals_jax(block, firsts, reserved, s):
    arch_j, arch, p_j, blk = block
    rng = np.random.RandomState(sum(firsts) + s)
    b, g, d, m = len(firsts), arch.num_kv_heads, arch.head_dim, 4
    n_pages = 1 + sum(reserved)
    table = np.zeros((b, m), np.int32)
    nxt = 1
    for i, r in enumerate(reserved):
        table[i, :r] = nxt + rng.permutation(r)
        nxt += r
    first = np.asarray(firsts, np.int32)
    positions = first[:, None] + np.arange(s, dtype=np.int32)[None]
    kp = rng.standard_normal((n_pages, PS, g, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, g, d)).astype(np.float32)
    x = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
    out_j, pool_j = JB.attn_apply(
        arch_j, p_j, jnp.asarray(x), positions=jnp.asarray(positions),
        cache={"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
        page_table=jnp.asarray(table), append=True)
    pool = {"kp": torch.from_numpy(kp.copy()), "vp": torch.from_numpy(vp.copy())}
    with torch.no_grad():
        out, new = blk(torch.from_numpy(x), positions=torch.from_numpy(positions),
                       cache=pool, page_table=torch.from_numpy(table),
                       append=True)
    assert new is pool
    _close(out.numpy(), out_j, "block output")
    for name in ("kp", "vp"):
        _close(pool[name].numpy(), pool_j[name], f"pool {name}")


def test_multi_query_plain_version_is_one_query_per_position():
    """``paged_attention`` with q [B, S, H, D] on CPU tensors: query j is
    the one-query form over ``min(lengths + j, M·ps)`` keys, over fp
    pools and over int8 pools with their scale pools (the int8 body's
    multi-query form, the verify of an INT8 target)."""
    rng = np.random.RandomState(3)
    b, s, h, g, d, ps, m = 3, 5, 8, 2, 16, 4, 6
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((20, ps, g, d)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((20, ps, g, d)).astype(np.float32))
    table = torch.from_numpy(rng.randint(0, 20, (b, m)).astype(np.int32))
    lengths = torch.tensor([1, 13, m * ps], dtype=torch.int32)
    got = ops.paged_attn(q, kp, vp, table, lengths)
    for j in range(s):
        want = ops.paged_attn(q[:, j], kp, vp, table,
                              torch.clamp(lengths + j, max=m * ps))
        assert torch.equal(got[:, j], want)
    kq = (kp * 30).round().clamp(-127, 127).to(torch.int8)
    vq = (vp * 30).round().clamp(-127, 127).to(torch.int8)
    ks = torch.from_numpy(rng.uniform(0.01, 0.05, (20, ps, g, 1))
                          .astype(np.float32))
    vs = torch.from_numpy(rng.uniform(0.01, 0.05, (20, ps, g, 1))
                          .astype(np.float32))
    got = ops.paged_attn(q, kq, vq, table, lengths, k_scale=ks, v_scale=vs)
    for j in range(s):
        want = ops.paged_attn(q[:, j], kq, vq, table,
                              torch.clamp(lengths + j, max=m * ps),
                              k_scale=ks, v_scale=vs)
        assert torch.equal(got[:, j], want)
    # the plain version dequantises the pools, as the reference's gather
    deq = ops.paged_attn(q, kq.float() * ks, vq.float() * vs, table, lengths)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# speculative streams against the JAX spec engine and target-only
# ---------------------------------------------------------------------------

_TREES = {}


def _trees():
    if not _TREES:
        arch_j = jax_get_arch(ARCH_ID).reduced()
        cold_j = dataclasses.replace(arch_j, num_layers=1)
        _TREES["target"] = _liven(jax.tree.map(np.asarray, JREG.init_params(
            arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
        _TREES["cold"] = _liven(jax.tree.map(np.asarray, JREG.init_params(
            cold_j, jax.random.PRNGKey(SEED + 5), jnp.float32)), SEED + 2)
    return _TREES


def _archs(draft):
    arch_j, arch = jax_get_arch(ARCH_ID).reduced(), get_arch(ARCH_ID).reduced()
    if draft == "self":
        return arch_j, arch, arch_j, arch
    return (arch_j, arch, dataclasses.replace(arch_j, num_layers=1),
            dataclasses.replace(arch, num_layers=1))


def _sp(method):
    return SamplingParams("top_k", 0.8, 5) if method == "top_k" \
        else SamplingParams()


def _prompt_set():
    return _prompts(jax_get_arch(ARCH_ID).reduced(), N_REQ, MAX_LEN, SEED + 1,
                    MAX_NEW)


def _drain(eng, request):
    for i, p in enumerate(_prompt_set()):
        eng.submit(request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=2000)
    return {r.rid: list(r.out_tokens) for r in eng.completed}


def _jax_spec(draft, k, paged, method, int8=False):
    from repro import quant as JQ
    arch_j, _, draft_j, _ = _archs(draft)
    trees = _trees()
    params = {"target": jax.tree.map(jnp.asarray, trees["target"]),
              "draft": jax.tree.map(jnp.asarray, trees[
                  "target" if draft == "self" else "cold"])}
    sp = _sp(method)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = JServingEngine(arch_j, params, dtype=jnp.float32, config=JServeConfig(
            slots=SLOTS, max_len=MAX_LEN, seed=SEED, lookahead=0,
            sampling=JS.SamplingParams(sp.method, sp.temperature, sp.top_k),
            paging=JPagingConfig(paged=paged, page_size=PS),
            spec=JSpecConfig(draft=draft_j, k=k),
            quant=JQ.INT8_SERVE if int8 else JQ.QuantConfig()))
    return eng, _drain(eng, JRequest)


def _port(draft, k, paged, method, lookahead=0, int8=False):
    from repro_torch.quant import INT8_SERVE, QuantConfig
    _, arch, _, draft_t = _archs(draft)
    trees = _trees()
    spec = None
    if k:
        params = bridge.from_jax_spec_params(
            {"target": trees["target"],
             "draft": trees["target" if draft == "self" else "cold"]},
            arch, draft_t, device="cpu")
        spec = SpecConfig(draft=draft_t, k=k)
        model = params["target"]
    else:
        params = model = bridge.from_jax_params(trees["target"], arch,
                                                device="cpu")
    eng = ServingEngine(arch, params, device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, seed=SEED, lookahead=lookahead,
        sampling=_sp(method), paging=PagingConfig(paged=paged, page_size=PS),
        spec=spec, quant=INT8_SERVE if int8 else QuantConfig()))
    return eng, model, _drain(eng, Request)


_TARGET_ONLY = {}


def _target_only(paged, method):
    key = (paged, method)
    if key not in _TARGET_ONLY:
        _TARGET_ONLY[key] = _port(None, 0, paged, method)[2]
    return _TARGET_ONLY[key]


# (draft, k, paged, sampling, lookahead)
SPEC_CASES = [("self", 3, False, "greedy", 0), ("self", 1, True, "greedy", 1),
              ("cold", 1, False, "greedy", 1), ("cold", 3, True, "greedy", 0),
              ("self", 3, True, "top_k", 0), ("cold", 1, False, "top_k", 0)]


@pytest.mark.parametrize("draft,k,paged,method,lookahead", SPEC_CASES)
def test_spec_streams_equal_jax_spec_engine_and_target_only(
        draft, k, paged, method, lookahead):
    jeng, want = _jax_spec(draft, k, paged, method)
    eng, model, got = _port(draft, k, paged, method, lookahead)
    sp = _sp(method)
    bad = stream_diff(model, _prompt_set(), got, want, sp)
    assert not bad, f"against the JAX spec engine: {bad}"
    bad = stream_diff(model, _prompt_set(), got, _target_only(paged, method),
                      sp)
    assert not bad, f"against target-only: {bad}"
    assert all(len(t) == MAX_NEW for t in got.values())
    stats, jstats = eng.step_stats(), jeng.step_stats()
    if lookahead == 0:  # the same steps, each request in the same slot
        for name in ("accepted", "proposed", "rng"):
            assert np.array_equal(
                getattr(eng.state, name).numpy(),
                np.asarray(getattr(jeng.state, name)).astype(
                    np.int64 if name == "rng" else np.int32)), name
        for name in ("draft_acceptance", "accepted_tokens_mean"):
            assert stats[name] == pytest.approx(jstats[name]), name
    if draft == "self" and method == "greedy":
        assert stats["draft_acceptance"] > 0.99
        assert stats["accepted_tokens_mean"] > 1.0
    if draft == "cold":  # the 1-layer draft is rejected
        assert stats["draft_acceptance"] < 0.5
    if method == "top_k":  # sampled verify: some proposals rejected
        assert 0 < int(eng.state.proposed.sum())
    assert int(eng.state.accepted.sum()) <= int(eng.state.proposed.sum())


@pytest.mark.parametrize("draft,k,paged", [("cold", 3, False),
                                            ("self", 2, True)])
def test_int8_spec_streams_and_counters_equal_jax(draft, k, paged):
    """Speculative decoding under ``INT8_SERVE``: the target's weights
    and grid (or pool) int8, the draft and its grid fp, as the reference
    quantises the target only; greedy streams, ``accepted``,
    ``proposed`` and the stats equal the JAX quantised spec engine's
    (a flip only as a near-tie), and the verify reads the int8 grid
    through the int8 body's multi-query form."""
    jeng, want = _jax_spec(draft, k, paged, "greedy", int8=True)
    eng, model, got = _port(draft, k, paged, "greedy", int8=True)
    bad = stream_diff(model, _prompt_set(), got, want, _sp("greedy"))
    assert not bad, bad
    assert model.weights_quantized and not eng.draft.weights_quantized
    assert eng.caches[0]["kp" if paged else "k"].dtype == torch.int8
    assert eng.state.draft_caches[0]["k"].dtype == torch.float32
    for name in ("accepted", "proposed"):
        assert np.array_equal(getattr(eng.state, name).numpy(),
                              np.asarray(getattr(jeng.state, name))), name
    stats, jstats = eng.step_stats(), jeng.step_stats()
    for name in ("draft_acceptance", "accepted_tokens_mean"):
        assert stats[name] == pytest.approx(jstats[name]), name
    assert all(len(t) == MAX_NEW for t in got.values())


def test_spec_state_leaves_and_record_shape():
    eng, _, _ = _port("cold", 3, False, "greedy")
    st = eng.state
    assert len(st.draft_caches) == 1 and st.draft_caches[0]["k"].shape[:2] == \
        (SLOTS, MAX_LEN)
    assert st.accepted.dtype == st.proposed.dtype == torch.int32
    assert eng.decode().shape == (2 * 4 + 1, SLOTS)  # k + 1 sub-steps


def test_spec_pairing_rules_and_refusals():
    _, arch, _, cold = _archs("cold")
    trees = _trees()
    pair = lambda: bridge.from_jax_spec_params(  # noqa: E731
        {"target": trees["target"], "draft": trees["cold"]}, arch, cold,
        device="cpu")
    with pytest.raises(ValueError, match="SpecConfig.k"):
        SpecConfig(draft=cold, k=0)
    with pytest.raises(ValueError, match="unresolved"):
        ServingEngine(arch, pair(), device="cpu", config=ServeConfig(
            slots=2, max_len=16, spec=SpecConfig()))
    with pytest.raises(TypeError, match="target"):
        ServingEngine(arch, pair()["target"], device="cpu", config=ServeConfig(
            slots=2, max_len=16, spec=SpecConfig(draft=cold)))
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(arch, pair(), device="cpu", config=ServeConfig(
            slots=2, max_len=16, spec=SpecConfig(draft=dataclasses.replace(
                cold, vocab_size=cold.vocab_size + 1))))
    hybrid = get_arch("recurrentgemma-2b").reduced()
    with pytest.raises(NotImplementedError, match="dense-attention"):
        ServingEngine(arch, pair(), device="cpu", config=ServeConfig(
            slots=2, max_len=16, spec=SpecConfig(draft=hybrid)))
    with pytest.raises(KeyError):
        bridge.from_jax_spec_params({"target": trees["target"]}, arch, cold,
                                    device="cpu")
