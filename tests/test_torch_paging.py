"""The port's paged KV pool with prefix reuse (``repro_torch.serving.pages``,
the paged branches of ``models.blocks``, the paged scheduler and engine)
and the int8 ``flash_attention`` plain versions against the JAX package,
on ``qwen1.5-0.5b.reduced()`` in fp32 on the CPU.

Inputs come from numpy seeds; weights are the JAX init carried over by
``bridge.from_jax_params``, with seeded norms and biases and scaled-up
output projections so that greedy streams do not just repeat their
last prompt token (as in tests/test_torch_serving.py's INT8 tree).

* ``PagePool`` / ``PrefixRegistry`` give the JAX classes' page ids,
  refcounts, lookups, hits and evictions over scripted sequences.
* ``make_paged_caches``, ``splice_pages``, ``copy_pages`` and
  ``gather_prefix`` match JAX's pools: fp pools equal, int8 payloads and
  scales bit-equal (page 0, the null page, holds garbage by construction
  and is left out); the gathered int8 prefix, dequantised, equals JAX's
  dequantised gather.
* ``flash_attention_ref`` with scales matches ``repro.kernels.ref`` and
  the interpret-mode Pallas ``_flash_kernel_q8``; ``prefix_attention_ref``
  and ``AttnBlock`` with a gathered prefix match the JAX block.
* Paged greedy streams equal the port's dense streams and
  ``ReferenceEngine``'s (``basic``, ``churn``, ``eos``, ``shared``; plus
  ``shared_cow``, whose owner prompt is the shared prefix itself, so the
  sharers copy its frontier page on write) at lookahead 0 and 1; INT8
  paged streams equal the JAX paged quantised engine's; an
  oversubscribed pool queues, drains and frees every page.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as JB
from repro.models import registry as JREG
from repro.serving import pages as JPG
from repro.serving.config import PagingConfig as JPagingConfig
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import ReferenceEngine, _prompts
from repro_torch import bridge
from repro_torch import quant as Q
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.quant import INT8_SERVE
from repro_torch.serving import (PagingConfig, Request, ServeConfig,
                                 ServingEngine)
from repro_torch.serving import pages as PG

ARCH_ID = "qwen1.5-0.5b"
SLOTS, MAX_LEN, MAX_NEW, SEED, PS = 4, 32, 6, 0, 8
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    """(JAX arch, JAX params, port arch, numpy tree)."""
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    tree = jax.tree.map(np.asarray, JREG.init_params(
        arch_j, jax.random.PRNGKey(SEED), jnp.float32))
    rng = np.random.RandomState(SEED + 1)
    body = dict(tree["body"]["b0_attn"])
    for name in ("ln1", "ln2", "bq", "bk", "bv"):
        body[name] = (0.5 * rng.standard_normal(body[name].shape)).astype(np.float32)
    body["wo"] = body["wo"] * 8.0
    body["mlp"] = {k: v * 8.0 for k, v in body["mlp"].items()}
    tree["body"] = {"b0_attn": body}
    return arch_j, jax.tree.map(jnp.asarray, tree), arch, tree


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


# ---------------------------------------------------------------------------
# host accounting
# ---------------------------------------------------------------------------

def test_page_pool_matches_jax():
    pools = (PG.PagePool(8, page_size=4), JPG.PagePool(8, page_size=4))
    script = [("alloc", 3), ("release", [2]), ("alloc", 1), ("retain", [1, 3]),
              ("release", [1]), ("alloc", 2), ("release", [1, 3, 3]),
              ("alloc", 4), ("release", [5])]
    for op, arg in script:
        got = [getattr(p, op)(arg) for p in pools]
        assert got[0] == got[1], (op, arg, got)
        np.testing.assert_array_equal(pools[0].refcount, pools[1].refcount)
        assert pools[0].free_pages == pools[1].free_pages
        assert pools[0].used_pages == pools[1].used_pages
    errs = []
    for p, exc in zip(pools, (PG.PagePoolExhausted, JPG.PagePoolExhausted)):
        with pytest.raises(exc) as ei:
            p.alloc(p.free_pages + 1, waiting=[11, 12])
        errs.append((ei.value.waiting, str(ei.value)))
    assert errs[0] == errs[1] and errs[0][0] == [11, 12]
    for p in pools:
        (page,) = p.alloc(1)
        p.release([page])
        with pytest.raises(AssertionError, match="double free"):
            p.release([page])


def test_prefix_registry_matches_jax():
    rng = np.random.RandomState(3)
    sys_prompt = rng.randint(1, 100, size=9).astype(np.int32)
    prompts = [sys_prompt,
               np.concatenate([sys_prompt, [7, 8, 9]]).astype(np.int32),
               rng.randint(1, 100, size=13).astype(np.int32),
               np.concatenate([sys_prompt[:4], [5] * 6]).astype(np.int32)]
    sides = []
    for mod in (PG, JPG):
        pool = mod.PagePool(40, page_size=4)
        reg = mod.PrefixRegistry(pool, cap=6)
        log, owned = [], []
        for i, p in enumerate(prompts):
            m, chain, frontier = reg.lookup(p)
            log.append(("lookup", i, m, tuple(chain), frontier))
            pages = pool.alloc(-(-len(p) // 4))
            owned += pages
            reg.register(p, pages)
            log.append(("refcount", i, pool.refcount.tolist(), len(reg.full),
                        len(reg.tail)))
        log.append(("probe", reg.lookup(np.concatenate([sys_prompt, [1]]))))
        log.append(("pinned", reg.evict_unreferenced()))  # slots hold them
        pool.release(owned)  # the slots retire
        log.append(("evict", reg.evict_unreferenced(), pool.refcount.tolist()))
        log.append(("hits", reg.hits, reg.misses, len(reg.full), len(reg.tail)))
        reg.clear()
        log.append(("clear", pool.refcount.tolist()))
        sides.append(log)
    assert sides[0] == sides[1]
    assert any(e[0] == "lookup" and e[4] is not None for e in sides[0])  # mid-page
    assert sides[0][-1][1][1:] == [0] * 39


# ---------------------------------------------------------------------------
# pools: construction, splice, copy-on-write, gather
# ---------------------------------------------------------------------------

def _pool_np(pools_port, pools_jax, name):
    """One leaf of every layer, the port's and JAX's, as numpy [L, P, ...]."""
    got = np.stack([p[name].numpy() for p in pools_port])
    return got, np.asarray(pools_jax["body"]["b0_attn"][name])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_make_paged_caches_matches_jax(setup, kv_quant):
    arch_j, _, arch, _ = setup
    want = JPG.make_paged_caches(arch_j, 5, PS, jnp.float32, kv_quant=kv_quant)
    got = PG.make_paged_caches(arch, 5, PS, device="cpu", dtype=torch.float32,
                               kv_quant=kv_quant)
    assert len(got) == arch.num_layers
    names = set(want["body"]["b0_attn"])
    assert names == ({"kp", "vp", "kps", "vps"} if kv_quant else {"kp", "vp"})
    for name in names:
        g, w = _pool_np(got, want, name)
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype), name


@pytest.mark.parametrize("kv_quant", [False, True])
def test_splice_copy_gather_match_jax(setup, kv_quant):
    """fp rows spliced (quantised at the scatter for an int8 pool), a
    frontier page copied on write, a prefix gathered."""
    arch_j, _, arch, _ = setup
    n_layers, g, d = arch.num_layers, arch.num_kv_heads, arch.head_dim
    n, s, kv_pages = 2, 16, 12
    rng = np.random.RandomState(5)
    k = rng.standard_normal((n_layers, n, s, g, d)).astype(np.float32)
    v = rng.standard_normal((n_layers, n, s, g, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (n, 1)) + np.array([[0], [3]])
    pos[0, 11:] = -1  # row 0: 11 valid tokens
    page_rows = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)

    jpools = JPG.make_paged_caches(arch_j, kv_pages, PS, jnp.float32,
                                   kv_quant=kv_quant)
    jrows = {"body": {"b0_attn": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                  "pos": jnp.asarray(np.stack([pos] * n_layers)),
                                  "count": jnp.zeros((n_layers,), jnp.int32)}}}
    jpools = JPG.splice_pages(jpools, jrows, jnp.asarray(page_rows))
    jpools = JPG.copy_pages(jpools, jnp.asarray([9], jnp.int32),
                            jnp.asarray([2], jnp.int32))
    jpre = JPG.gather_prefix(jpools, jnp.asarray(page_rows[:, :2]),
                             jnp.asarray([11, 11], jnp.int32))

    pools = PG.make_paged_caches(arch, kv_pages, PS, device="cpu",
                                 dtype=torch.float32, kv_quant=kv_quant)
    rows = [{"k": torch.from_numpy(k[i]), "v": torch.from_numpy(v[i]),
             "pos": torch.from_numpy(pos)} for i in range(n_layers)]
    PG.splice_pages(pools, rows, torch.from_numpy(page_rows))
    PG.copy_pages(pools, [9], [2])
    pre = PG.gather_prefix(pools, torch.from_numpy(page_rows[:, :2]), 11)

    for name in pools[0]:
        got, want = _pool_np(pools, jpools, name)
        np.testing.assert_array_equal(got[:, 1:], want[:, 1:], err_msg=name)
    for name in ("kp", "vp"):
        got, _ = _pool_np(pools, jpools, name)
        assert np.any(got[:, 9] != 0) and np.array_equal(got[:, 9], got[:, 2])
    if kv_quant:
        assert pools[0]["kp"].dtype == torch.int8
    jb = jpre["body"]["b0_attn"]
    for i, layer in enumerate(pre):
        assert layer["pre_len"] == 11
        for name in ("k", "v"):
            g_ = layer[f"pre_{name}"]
            if kv_quant:
                assert g_.dtype == torch.int8
                g_ = g_.float() * layer[f"pre_{name}_scale"]
            np.testing.assert_array_equal(g_.numpy(),
                                          np.asarray(jb[f"pre_{name}"][i]))


# ---------------------------------------------------------------------------
# attention: the int8 flash body and the shared-prefix form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,s,t", [
    (True, 0, 24, 24), (True, 0, 37, 37), (True, 5, 29, 29),
    (False, 0, 13, 21)])
def test_flash_attention_ref_q8_matches_jax(causal, window, s, t):
    rng = np.random.RandomState(7)
    bh, d = 3, 16
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    kq = JQ.quantize_kv(jnp.asarray(rng.standard_normal((bh, t, 1, d)),
                                    jnp.float32))
    vq = JQ.quantize_kv(jnp.asarray(rng.standard_normal((bh, t, 1, d)),
                                    jnp.float32))
    jargs = (jnp.asarray(q), kq.q[:, :, 0], vq.q[:, :, 0])
    jscales = dict(k_scale=kq.scale[:, :, 0], v_scale=vq.scale[:, :, 0])
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    tscales = {n: torch.from_numpy(np.array(a)) for n, a in jscales.items()}
    got = ops.attention(*targs, causal=causal, window=window, **tscales)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bh, s, d)
    want_ref = jref.flash_attention_ref(*jargs, causal=causal, window=window,
                                        **jscales)
    want_pallas = jops.attention(*jargs, causal=causal, window=window,
                                 **jscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)


def _prefix_inputs(arch, kv_quant, pre_len, lp, s, suf_len, seed=11):
    """A gathered prefix (JAX form: fp32, dequantised for int8; port form:
    the pool payload) and a suffix batch of 2 rows."""
    rng = np.random.RandomState(seed)
    g, d, n = arch.num_kv_heads, arch.head_dim, 2
    pk = rng.standard_normal((n, lp, g, d)).astype(np.float32)
    pv = rng.standard_normal((n, lp, g, d)).astype(np.float32)
    x = rng.standard_normal((n, s, arch.d_model)).astype(np.float32)
    port = {"pre_len": pre_len}
    if kv_quant:
        kq, vq = Q.quantize_kv(torch.from_numpy(pk)), Q.quantize_kv(torch.from_numpy(pv))
        port.update(pre_k=kq.q, pre_v=vq.q, pre_k_scale=kq.scale,
                    pre_v_scale=vq.scale)
        pk, pv = (kq.q.float() * kq.scale).numpy(), (vq.q.float() * vq.scale).numpy()
    else:
        port.update(pre_k=torch.from_numpy(pk), pre_v=torch.from_numpy(pv))
    jcache = {"pre_k": jnp.asarray(pk), "pre_v": jnp.asarray(pv),
              "pre_len": jnp.full((n,), pre_len, jnp.int32)}
    positions = pre_len + np.tile(np.arange(s, dtype=np.int32), (n, 1))
    seq_lens = np.array([pre_len + suf_len[0], pre_len + suf_len[1]], np.int32)
    return x, port, jcache, positions, seq_lens


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("pre_len,lp", [(8, 8), (11, 16), (5, 24)])
def test_prefix_attention_matches_jax_block(setup, kv_quant, pre_len, lp):
    """``prefix_attention_ref`` against the JAX ``_shared_prefix_attention``
    on the same q/k/v, and ``AttnBlock`` against ``attn_apply`` with the
    gathered prefix; rows past a suffix's length are padding (the
    scheduler invalidates them) and are not compared."""
    arch_j, params, arch, tree = setup
    s, suf_len = 8, (8, 5)
    x, port, jcache, positions, seq_lens = _prefix_inputs(
        arch, kv_quant, pre_len, lp, s, suf_len)
    p0 = jax.tree.map(lambda a: a[0], params["body"]["b0_attn"])
    jx, jrow = JB.attn_apply(arch_j, p0, jnp.asarray(x), None,
                             positions=jnp.asarray(positions), cache=jcache,
                             seq_lens=jnp.asarray(seq_lens))
    model = bridge.from_jax_params(tree, arch, device="cpu")
    block = model.layers[0]
    with torch.no_grad():
        tx, trow = block(torch.from_numpy(x), positions=torch.from_numpy(positions),
                         cache=port, seq_lens=torch.from_numpy(seq_lens))
    for b, n_valid in enumerate(suf_len):
        np.testing.assert_allclose(tx[b, :n_valid].numpy(),
                                   np.asarray(jx[b, :n_valid]), **TOL)
    np.testing.assert_allclose(trow["k"].numpy(), np.asarray(jrow["k"]), **TOL)
    np.testing.assert_array_equal(trow["pos"].numpy(), positions)

    # the plain version alone, q/k/v [B, S, H, D] as the block makes them
    rng = np.random.RandomState(2)
    h, d = arch.num_heads, arch.head_dim
    q, k, v = (rng.standard_normal((2, s, h, d)).astype(np.float32)
               for _ in range(3))
    want = JB._shared_prefix_attention(None, jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jcache,
                                       jnp.asarray(positions),
                                       jnp.asarray(seq_lens))
    got = ops.prefix_attention_ref(
        *(torch.from_numpy(a).permute(0, 2, 1, 3).reshape(2 * h, -1, d)
          for a in (q,)),
        port["pre_k"].permute(0, 2, 1, 3).reshape(2 * h, lp, d),
        port["pre_v"].permute(0, 2, 1, 3).reshape(2 * h, lp, d), pre_len,
        *(torch.from_numpy(a).permute(0, 2, 1, 3).reshape(2 * h, s, d)
          for a in (k, v)),
        **({} if not kv_quant else {
            n: port[n].permute(0, 2, 1, 3).reshape(2 * h, lp, 1)
            for n in ("pre_k_scale", "pre_v_scale")}))
    got = got.reshape(2, h, s, d).permute(0, 2, 1, 3).numpy()
    for b, n_valid in enumerate(suf_len):
        np.testing.assert_allclose(got[b, :n_valid], np.asarray(want[b, :n_valid]),
                                   **TOL)


# ---------------------------------------------------------------------------
# engines: paged streams
# ---------------------------------------------------------------------------

def _scenario(name):
    """(prompts, slots, rid admitted one step ahead or None)."""
    arch = jax_get_arch(ARCH_ID).reduced()
    if name == "basic":
        return _prompts(arch, SLOTS, MAX_LEN, SEED, MAX_NEW), SLOTS, None
    if name == "churn":
        return _prompts(arch, 6, MAX_LEN, SEED + 1, MAX_NEW), 2, None
    if name == "eos":
        return _prompts(arch, 2, MAX_LEN, SEED + 2, MAX_NEW), 2, None
    # serving_equiv's shared scenario: a (page_size + 1)-token prefix and
    # three tails, the owner (rid 0) one step ahead; shared_cow adds the
    # prefix alone as the owner, so the sharers match it mid-page
    prng = np.random.RandomState(SEED + 3)
    pre = prng.randint(1, 256, size=PS + 1).astype(np.int32)
    tails = [prng.randint(1, 256, size=s).astype(np.int32) for s in (4, 6, 3)]
    prompts = [np.concatenate([pre, t]) for t in tails]
    if name == "shared_cow":
        prompts = [pre] + prompts
    return prompts, SLOTS, 0


def _drive(eng, prompts, first, req_cls):
    if first is not None:
        eng.submit(req_cls(rid=first, prompt=prompts[first],
                           max_new_tokens=MAX_NEW))
        eng.step()  # the owner is admitted and registered first
    for i, p in enumerate(prompts):
        if i != first:
            eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_until_drained(max_steps=4000)
    return {r.rid: list(r.out_tokens) for r in eng.completed}


_CACHE = {}


def _reference(setup, name, eos_id=None):
    key = ("ref", name, eos_id)
    if key not in _CACHE:
        arch_j, params, _, _ = setup
        prompts, slots, _ = _scenario(name)
        eng = ReferenceEngine(arch_j, params, slots=slots, max_len=MAX_LEN,
                              eos_id=eos_id, dtype=jnp.float32)
        _CACHE[key] = _drive(eng, prompts, None, JRequest)
    return _CACHE[key]


def _jax_paged(setup, name, quant=False):
    """(streams, prefix_hit_rate) of the JAX paged engine."""
    key = ("jax", name, quant)
    if key not in _CACHE:
        arch_j, params, _, _ = setup
        prompts, slots, first = _scenario(name)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                 config=JServeConfig(
                                     slots=slots, max_len=MAX_LEN,
                                     paging=JPagingConfig(paged=True,
                                                          page_size=PS),
                                     quant=JQ.INT8_SERVE if quant
                                     else JQ.QuantConfig()))
        streams = _drive(eng, prompts, first, JRequest)
        _CACHE[key] = streams, eng.prefill_stats()["prefix_hit_rate"]
    return _CACHE[key]


def _port(setup, name, *, paged, lookahead=1, eos_id=None, quant=False,
          **paging):
    _, _, arch, tree = setup
    prompts, slots, first = _scenario(name)
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, eos_id=eos_id, lookahead=lookahead,
        paging=PagingConfig(paged=paged, page_size=PS, **paging),
        quant=INT8_SERVE if quant else Q.QuantConfig()))
    return eng, _drive(eng, prompts, first, Request)


def _all_pages_free(eng):
    sched = eng.scheduler
    assert not sched.slot_pages
    sched.registry.evict_unreferenced()
    assert not sched.registry.full and not sched.registry.tail
    assert sched.pool.free_pages == sched.pool.kv_pages - 1


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("scenario", ["basic", "churn", "eos", "shared",
                                      "shared_cow"])
def test_paged_streams_match_dense_and_reference(setup, scenario, lookahead):
    eos_ids = [None]
    if scenario == "eos":  # EOS straight out of prefill, and mid-stream
        probe = _reference(setup, "eos")
        eos_ids = [probe[0][0], probe[1][2]]
    for eos in eos_ids:
        want = _reference(setup, scenario, eos_id=eos)
        eng, got = _port(setup, scenario, paged=True, lookahead=lookahead,
                         eos_id=eos)
        _, dense = _port(setup, scenario, paged=False, lookahead=lookahead,
                         eos_id=eos)
        assert got == want, (eos, got, want)
        assert dense == want, (eos, dense, want)
        assert isinstance(eng.caches[0], dict) and "kp" in eng.caches[0]
        _all_pages_free(eng)
    if scenario == "basic":
        assert any(len(set(toks)) > 2 for toks in want.values()), want
    if scenario.startswith("shared"):
        hit = eng.prefill_stats()["prefix_hit_rate"]
        assert hit > 0 and hit == _jax_paged(setup, scenario)[1]
        assert eng.prefill_stats()["shared_dispatches"] >= 1


@pytest.fixture
def jax_int8_shared_prefill(monkeypatch):
    """Lets the JAX paged engine run a shared-prefix prefill under int8 KV.
    There its ``invalidate_padding`` receives the suffix's fp rows (``k``,
    ``v``, ``pos``, ``count``) with the quantised cache's axes (which add
    ``k_scale``/``v_scale``), and ``tree_map`` fails on the key mismatch
    (a fault of the JAX package, ROADMAP C). Only ``pos`` is invalidated,
    so the axes are pruned to the rows' keys; nothing else changes."""
    from repro.serving import scheduler as JS
    orig = JS.invalidate_padding

    def prune(row, axes):
        if isinstance(row, dict):
            return {k: prune(v, axes[k]) for k, v in row.items()}
        return axes

    monkeypatch.setattr(JS, "invalidate_padding", lambda row, true_len, axes:
                        orig(row, true_len, prune(row, axes)))


@pytest.mark.parametrize("scenario", ["basic", "shared", "shared_cow"])
def test_int8_paged_streams_match_jax_paged_engine(setup, scenario,
                                                   jax_int8_shared_prefill):
    want, hit = _jax_paged(setup, scenario, quant=True)
    eng, got = _port(setup, scenario, paged=True, quant=True)
    assert got == want, (got, want)
    assert eng.caches[0]["kp"].dtype == torch.int8 and "kps" in eng.caches[0]
    assert eng.model.weights_quantized
    assert eng.prefill_stats()["prefix_hit_rate"] == hit
    if scenario == "basic":
        assert any(len(set(toks)) > 2 for toks in want.values()), want


@pytest.mark.parametrize("eos", [False, True])
def test_oversubscribed_pool_queues_drains_and_frees(setup, eos):
    """4 usable pages where a request needs 2-4 (``churn``, with and without
    an EOS that fires): admissions hit exhaustion, wait in the queue and
    drain; every page is released exactly once (a second release would
    raise) and all are free after the registry's cold entries go."""
    eos_id = _reference(setup, "churn")[1][1] if eos else None
    want = _reference(setup, "churn", eos_id=eos_id)
    _, _, arch, tree = setup
    prompts, slots, _ = _scenario("churn")
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=slots, max_len=MAX_LEN, eos_id=eos_id, paging=PagingConfig(
            paged=True, page_size=PS, kv_pages=5)))
    pool = eng.scheduler.pool
    exhausted = []
    alloc = pool.alloc

    def counting_alloc(n, waiting=()):
        try:
            return alloc(n, waiting)
        except PG.PagePoolExhausted as e:
            exhausted.append(e.waiting)
            raise

    pool.alloc = counting_alloc
    got = _drive(eng, prompts, None, Request)
    assert got == want
    assert exhausted and all(w for w in exhausted)
    if eos:
        assert any(len(t) < MAX_NEW for t in want.values()), want
    _all_pages_free(eng)


def test_paged_engine_pool_geometry(setup):
    _, _, arch, tree = setup
    model = bridge.from_jax_params(tree, arch, device="cpu")
    eng = ServingEngine(arch, model, device="cpu", config=ServeConfig(
        slots=3, max_len=20, paging=PagingConfig(paged=True, page_size=PS),
        quant=Q.QuantConfig(kv="int8")))
    assert eng.kv_pages == PG.default_kv_pages(3, 20, PS) == 3 * 3 + 1
    assert tuple(eng.state.page_table.shape) == (3, 3)
    assert tuple(eng.caches[0]["kp"].shape) == (10, PS, arch.num_kv_heads,
                                                 arch.head_dim)
    assert tuple(eng.caches[0]["kps"].shape) == (10, PS, arch.num_kv_heads, 1)
    assert not eng.model.weights_quantized
