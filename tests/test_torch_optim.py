"""The port's AdamW, learning-rate schedule and gradient compression
against the JAX package's, fp32 on the CPU.

The same params (bridged from ``repro.models.registry.init_params``) and
the same seeded gradients go through ``repro.optim.adamw.adamw_update``
and the port's in-place ``optim.adamw.adamw_update`` for two steps: new
params and fp32 state at 2e-4 (the summation order of the global norm
differs). The int8 state quantises each stacked leaf of the reference
with one per-tensor scale; the port's groups (``quant.stack_groups``)
share that scale across a stack's layers, so payloads agree up to 1
where fp32 rounding moves a value across a rounding tie, and scales to
1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import registry as JREG
from repro.optim import adamw as JOPT
from repro.runtime import compression as JCOMP
from repro_torch import bridge
from repro_torch import quant as Q
from repro_torch.configs import get_arch
from repro_torch.optim import adamw as OPT
from repro_torch.runtime import compression as COMP

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_ID = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def pair():
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    params = JREG.init_params(arch_j, jax.random.PRNGKey(0), jnp.float32)
    return arch_j, params, arch


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              * 0.05), params)


@pytest.mark.parametrize("quantize", [False, True])
def test_adamw_update_matches_jax(pair, quantize):
    arch_j, params, arch = pair
    cfg_j = JOPT.AdamWConfig(lr=1e-3, quantize=quantize, clip_norm=0.5)
    cfg = OPT.AdamWConfig(lr=1e-3, quantize=quantize, clip_norm=0.5)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                   device="cpu")
    pj, oj = params, JOPT.adamw_init(params, cfg_j)
    opt = OPT.adamw_init(model, cfg)
    for seed, lr in ((1, 1e-3), (2, 5e-4)):
        gj = _grads(params, seed)
        pj, oj, info_j = JOPT.adamw_update(pj, gj, oj, cfg_j, jnp.float32(lr))
        grads = bridge.from_jax_tree(jax.tree.map(np.asarray, gj), arch)
        _, opt, info = OPT.adamw_update(model, grads, opt, cfg,
                                        torch.tensor(lr))
        np.testing.assert_allclose(float(info["grad_norm"]),
                                   float(info_j["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(info["clip_scale"]),
                                   float(info_j["clip_scale"]), rtol=1e-5)
        assert int(opt["step"]) == int(oj["step"])
        want = bridge.from_jax_tree(jax.tree.map(np.asarray, pj), arch)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **TOL, err_msg=name)
        for key in ("m", "v"):
            ref = bridge.from_jax_tree(oj[key], arch)
            for name, got in opt[key].items():
                if quantize:
                    assert Q.is_qtensor(got) and Q.is_qtensor(ref[name])
                    np.testing.assert_allclose(got.scale.numpy(),
                                               ref[name].scale.numpy(),
                                               rtol=1e-6, err_msg=name)
                    diff = np.abs(got.q.numpy().astype(np.int32)
                                  - ref[name].q.numpy().astype(np.int32))
                    assert diff.max() <= 1, name
                    assert (diff > 0).mean() < 1e-3, name
                else:
                    np.testing.assert_allclose(got.numpy(),
                                               ref[name].numpy(), **TOL,
                                               err_msg=name)


def test_int8_state_shares_a_scale_per_stacked_leaf(pair):
    arch_j, params, arch = pair
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                   device="cpu")
    cfg = OPT.AdamWConfig(quantize=True)
    opt = OPT.adamw_init(model, cfg)
    grads = {n: torch.randn(p.shape) for n, p in model.named_parameters()}
    OPT.adamw_update(model, grads, opt, cfg, 1e-3)
    groups = Q.stack_groups(model)
    assert ["layers.0.wq", "layers.1.wq"] in groups and ["embed"] in groups
    for group in groups:
        scales = {float(opt["m"][n].scale) for n in group}
        assert len(scales) == 1, group


@pytest.mark.parametrize("warmup,total", [(2, 20), (5, 5), (0, 10)])
def test_cosine_schedule_matches_jax(warmup, total):
    fj = JOPT.cosine_schedule(3e-4, warmup, total)
    ft = OPT.cosine_schedule(3e-4, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(
            float(ft(torch.tensor(step, dtype=torch.int32))),
            float(fj(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12)


def test_global_norm_matches_jax(pair):
    arch_j, params, arch = pair
    g = _grads(params, 7)
    want = float(JOPT.global_norm(g))
    got = float(OPT.global_norm(bridge.from_jax_tree(
        jax.tree.map(np.asarray, g), arch)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_int8_adam_close_to_fp32(pair):
    """As the reference's test: one update on constant grads, int8 state
    within 5e-4 of fp32 state."""
    arch_j, params, arch = pair
    out = []
    for quantize in (False, True):
        model = bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                       device="cpu")
        cfg = OPT.AdamWConfig(lr=1e-3, quantize=quantize)
        grads = {n: torch.full(p.shape, 0.01)
                 for n, p in model.named_parameters()}
        OPT.adamw_update(model, grads, OPT.adamw_init(model, cfg), cfg, 1e-3)
        out.append(model.state_dict())
    for name, a in out[0].items():
        np.testing.assert_allclose(a.numpy(), out[1][name].numpy(),
                                   atol=5e-4, err_msg=name)


def test_compress_matches_jax():
    rng = np.random.RandomState(3)
    g = rng.standard_normal((64, 9)).astype(np.float32)
    err = (rng.standard_normal((64, 9)) * 1e-3).astype(np.float32)
    qj, sj, ej = JCOMP.compress(jnp.asarray(g), jnp.asarray(err))
    q, s, e = COMP.compress(torch.tensor(g), torch.tensor(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(COMP.decompress(q, s).numpy(),
                                  np.asarray(JCOMP.decompress(qj, sj)))


def test_compressed_grads_match_jax(pair):
    arch_j, params, arch = pair
    gj = _grads(params, 5)
    err_j = JCOMP.init_error_feedback(params)
    model = bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                   device="cpu")
    err = COMP.init_error_feedback(dict(model.named_parameters()))
    grads = bridge.from_jax_tree(jax.tree.map(np.asarray, gj), arch)
    groups = Q.stack_groups(model)
    for _ in range(2):
        gj2, err_j = JCOMP.compressed_grads(gj, err_j)
        before = err
        g2, err = COMP.compressed_grads(grads, err, groups)
        want = bridge.from_jax_tree(jax.tree.map(np.asarray, gj2), arch)
        want_e = bridge.from_jax_tree(jax.tree.map(np.asarray, err_j), arch)
        for name, g in grads.items():
            np.testing.assert_allclose(g2[name].numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(err[name].numpy(),
                                       want_e[name].numpy(), rtol=0,
                                       atol=1e-7, err_msg=name)
            # error feedback: what is sent plus what is kept is g + err
            np.testing.assert_allclose((g2[name] + err[name]).numpy(),
                                       (g + before[name]).numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="error-feedback tree"):
        COMP.compressed_grads(grads, dict(list(err.items())[1:]))


def test_gradient_compression_error_feedback():
    """The EF property: the running mean of decompressed grads tracks the
    true gradient."""
    g_true = torch.tensor(np.random.RandomState(0).standard_normal(64)
                          .astype(np.float32))
    err = torch.zeros(64)
    total = torch.zeros(64)
    for _ in range(50):
        q, s, err = COMP.compress(g_true, err)
        total += COMP.decompress(q, s)
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(), rtol=0,
                               atol=0.02)
