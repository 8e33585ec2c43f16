"""The port's dense LM vs the JAX package's ``LM.forward`` on the same
weights (carried over by ``repro_torch.bridge``), fp32 on the CPU.

The prefill is right-padded to a bucket with per-row true lengths: the
JAX side masks the padded keys (``seq_lens``), the port's
``flash_attention`` has no length operand (neither has the TPU kernel),
so valid rows are compared and padded rows are not. Tolerance 2e-4, the
tests/test_kernels.py fp32 tolerance: ``_attend_block`` scales q before
its dot, the kernels scale the scores after, so the two differ by
rounding only.

Under ``INT8_SERVE`` the port's quantised model (``quant.quantize_params``,
``quant_matmul``, int8 caches read by the int8 ``paged_attention``) is
held against ``LM.forward`` on ``dequantize_params(quantize_params(p))``
with ``make_caches(kv_quant=True)``: hidden states and logits at 2e-4,
cache scales at 2e-4 relative, and the dequantised K/V within one
quantisation step, because the fp32 summation order can move a K/V
value across a rounding boundary and its int8 by one.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShape
from repro.models import lm as JLM
from repro.models import registry as JREG
from repro_torch import bridge
from repro_torch import quant as Q
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import registry as REG

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_ID = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def pair():
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    params = JREG.init_params(arch_j, jax.random.PRNGKey(0), jnp.float32)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                   device="cpu")
    return arch_j, params, arch, model


def _prompts(n, bucket, lens, seed):
    rng = np.random.RandomState(seed)
    toks = np.zeros((n, bucket), np.int32)
    for i, s in enumerate(lens):
        toks[i, :s] = rng.randint(1, 256, size=s)
    return toks


def test_arch_copy_matches_jax_config():
    import dataclasses
    for reduce in (False, True):
        a = get_arch(ARCH_ID)
        b = jax_get_arch(ARCH_ID)
        if reduce:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ShapeConfig("s", 64, 4, "decode").reduced() == \
        ShapeConfig(**dataclasses.asdict(JShape("s", 64, 4, "decode").reduced()))


def test_bridge_unstacks_every_layer(pair):
    arch_j, params, arch, model = pair
    np.testing.assert_array_equal(model.embed.numpy(), np.asarray(params["embed"]))
    body = params["body"]["b0_attn"]
    for i, layer in enumerate(model.layers):
        np.testing.assert_array_equal(layer.wq.numpy(), np.asarray(body["wq"][i]))
        np.testing.assert_array_equal(layer.bv.numpy(), np.asarray(body["bv"][i]))
        np.testing.assert_array_equal(layer.mlp.w_down.numpy(),
                                      np.asarray(body["mlp"]["w_down"][i]))
    assert len(model.layers) == arch.num_layers


def test_bridge_rejects_mismatched_tree(pair):
    arch_j, params, arch, model = pair
    tree = jax.tree.map(np.asarray, params)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        bridge.from_jax_params(tree, arch, device="cpu")


def test_prefill_then_decode_matches_jax(pair):
    """Bucketed prefill with seq_lens into a longer grid, then two decode
    steps: hidden states, logits and every cache leaf at pos >= 0."""
    arch_j, params, arch, model = pair
    n, bucket, t = 3, 16, 32
    lens = np.array([5, 16, 9], np.int32)
    toks = _prompts(n, bucket, lens, seed=0)

    h_j, c_j = JLM.forward(arch_j, params, jnp.asarray(toks),
                           caches=JLM.make_caches(arch_j, n, t, jnp.float32),
                           seq_lens=jnp.asarray(lens))
    h_t, c_t = model(torch.from_numpy(toks), caches=model.make_caches(n, t))
    hj, ht = np.asarray(h_j), h_t.numpy()
    for i, s in enumerate(lens):
        np.testing.assert_allclose(ht[i, :s], hj[i, :s], **TOL)
        last_j = np.asarray(JLM.logits_fn(arch_j, params, h_j[i, s - 1]))
        np.testing.assert_allclose(model.logits(h_t[i, s - 1]).numpy(),
                                   last_j, **TOL)

    def check_caches(frontier):
        # entries of the padded bucket tail that no decode step has
        # overwritten yet hold padded rows' k/v: not compared
        idx = np.arange(t)[None, :]
        stale = (idx >= frontier[:, None]) & (idx < bucket)
        for layer in range(arch.num_layers):
            cj = {k: np.asarray(v[layer])
                  for k, v in c_j["body"]["b0_attn"].items()}
            ct = c_t[layer]
            valid = (cj["pos"] >= 0) & ~stale
            np.testing.assert_array_equal(ct["pos"].numpy(), cj["pos"])
            for leaf in ("k", "v"):
                np.testing.assert_allclose(ct[leaf].numpy()[valid],
                                           cj[leaf][valid], **TOL)

    check_caches(lens)
    rng = np.random.RandomState(1)
    pos = lens.copy()
    for _ in range(2):
        tok = rng.randint(1, 256, size=(n, 1)).astype(np.int32)
        h_j, c_j = JLM.forward(arch_j, params, jnp.asarray(tok), caches=c_j,
                               positions=jnp.asarray(pos[:, None]))
        h_t, c_t = model(torch.from_numpy(tok), caches=c_t,
                         positions=torch.from_numpy(pos[:, None]))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
        np.testing.assert_allclose(model.logits(h_t).numpy(),
                                   np.asarray(JLM.logits_fn(arch_j, params, h_j)),
                                   **TOL)
        pos += 1
        check_caches(pos)


@pytest.fixture(scope="module")
def qpair():
    """Non-zero seeded norms and biases (zeros would quantise to zeros);
    the JAX side's dequantised params and the port's quantised model."""
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    tree = jax.tree.map(np.asarray, JREG.init_params(
        arch_j, jax.random.PRNGKey(5), jnp.float32))
    rng = np.random.RandomState(6)
    body = tree["body"]["b0_attn"]
    for name in ("ln1", "ln2", "bq", "bk", "bv"):
        body[name] = (0.3 * rng.standard_normal(body[name].shape)).astype(np.float32)
    deq = JQ.dequantize_params(JQ.quantize_params(jax.tree.map(jnp.asarray, tree)))
    model = Q.quantize_params(bridge.from_jax_params(tree, arch, device="cpu"))
    return arch_j, deq, arch, model


def test_int8_prefill_then_decode_matches_jax(qpair):
    """INT8_SERVE: bucketed prefill with seq_lens into an int8 grid, then
    two decode steps over it (the int8 ``paged_attention`` body)."""
    arch_j, deq, arch, model = qpair
    n, bucket, t = 3, 16, 32
    lens = np.array([7, 16, 3], np.int32)
    toks = _prompts(n, bucket, lens, seed=3)
    h_j, c_j = JLM.forward(arch_j, deq, jnp.asarray(toks),
                           caches=JLM.make_caches(arch_j, n, t, jnp.float32,
                                                  kv_quant=True),
                           seq_lens=jnp.asarray(lens))
    h_t, c_t = model(torch.from_numpy(toks),
                     caches=model.make_caches(n, t, kv_quant=True))
    assert h_t.dtype == torch.float32
    hj, ht = np.asarray(h_j), h_t.numpy()
    for i, s in enumerate(lens):
        np.testing.assert_allclose(ht[i, :s], hj[i, :s], **TOL)
        np.testing.assert_allclose(
            model.logits(h_t[i, s - 1]).numpy(),
            np.asarray(JLM.logits_fn(arch_j, deq, h_j[i, s - 1])), **TOL)

    def check_caches(frontier):
        idx = np.arange(t)[None, :]
        stale = (idx >= frontier[:, None]) & (idx < bucket)
        for layer in range(arch.num_layers):
            cj = {k: np.asarray(v[layer])
                  for k, v in c_j["body"]["b0_attn"].items()}
            ct = {k: v.numpy() for k, v in c_t[layer].items()}
            assert ct["k"].dtype == np.int8 and ct["k_scale"].dtype == np.float32
            valid = (cj["pos"] >= 0) & ~stale
            np.testing.assert_array_equal(ct["pos"], cj["pos"])
            for leaf in ("k", "v"):
                sj, st = cj[f"{leaf}_scale"][valid], ct[f"{leaf}_scale"][valid]
                np.testing.assert_allclose(st, sj, rtol=2e-4, atol=0)
                step = np.maximum(sj, st)
                err = np.abs(ct[leaf][valid] * st - cj[leaf][valid] * sj)
                assert (err <= step * (1 + 1e-3)).all(), float((err / step).max())

    check_caches(lens)
    rng = np.random.RandomState(4)
    pos = lens.copy()
    for _ in range(2):
        tok = rng.randint(1, 256, size=(n, 1)).astype(np.int32)
        h_j, c_j = JLM.forward(arch_j, deq, jnp.asarray(tok), caches=c_j,
                               positions=jnp.asarray(pos[:, None]))
        h_t, c_t = model(torch.from_numpy(tok), caches=c_t,
                         positions=torch.from_numpy(pos[:, None]))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), **TOL)
        np.testing.assert_allclose(model.logits(h_t).numpy(),
                                   np.asarray(JLM.logits_fn(arch_j, deq, h_j)),
                                   **TOL)
        pos += 1
        check_caches(pos)


def test_int8_tied_unembedding_matches_jax(qpair):
    """``quant_matmul(x * s, q.T, ones)`` == x @ dequantize(embed).T."""
    arch_j, deq, arch, model = qpair
    x = np.random.RandomState(8).standard_normal((2, 3, arch.d_model)).astype(np.float32)
    np.testing.assert_allclose(model.logits(torch.from_numpy(x)).numpy(),
                               np.asarray(JLM.logits_fn(arch_j, deq, jnp.asarray(x))),
                               **TOL)


def test_prefill_step_and_legacy_serve_step_match_jax(pair):
    """``build_prefill_step`` (same-length prompts) then the legacy greedy
    ``serve_step``: logits and the chosen tokens."""
    arch_j, params, arch, model = pair
    b, s = 2, 8
    toks = _prompts(b, s, [s, s], seed=2)
    caches_j, logits_j = JREG.build_prefill_step(
        arch_j, JShape("p", s, b, "prefill"), cache_dtype=jnp.float32)(
        params, {"tokens": jnp.asarray(toks)})
    caches_t, logits_t = REG.build_prefill_step(arch, ShapeConfig("p", s, b, "prefill"))(
        model, torch.from_numpy(toks))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    nxt = np.asarray(jnp.argmax(logits_j[:, -1], axis=-1)).astype(np.int32)
    batch_pos = np.full((b, 1), s - 1, np.int32)  # ring slot s-1 of an s-long cache
    tok_j, _ = JREG.build_serve_step(arch_j)(
        params, caches_j, {"tokens": jnp.asarray(nxt[:, None]),
                           "positions": jnp.asarray(batch_pos)})
    tok_t, _ = REG.build_serve_step(arch)(
        model, caches_t, {"tokens": torch.from_numpy(nxt[:, None]),
                          "positions": torch.from_numpy(batch_pos)})
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


def test_init_params_draws_dense_init_distribution():
    arch = get_arch(ARCH_ID).reduced()
    a = REG.init_params(arch, 7, device="cpu")
    b = REG.init_params(arch, 7, device="cpu")
    c = REG.init_params(arch, 8, device="cpu")
    assert a.dtype == torch.float32  # fp32 on the CPU
    torch.testing.assert_close(a.embed, b.embed, rtol=0, atol=0)
    assert not torch.equal(a.embed, c.embed)
    w = a.layers[0].mlp.w_down  # fan_in = d_ff
    bound = 2.0 / math.sqrt(arch.d_ff)
    assert float(w.abs().max()) <= bound + 1e-6
    # std of N(0,1) truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) * math.sqrt(arch.d_ff) - 0.8796) < 0.05
    assert float(a.layers[0].ln1.abs().max()) == 0.0
    assert float(a.layers[0].bq.abs().max()) == 0.0
    assert REG.init_params(arch, 0, device="cpu",
                           dtype=torch.bfloat16).dtype == torch.bfloat16
