"""The port's training path against the JAX package, fp32 on the CPU.

The same seeded weights (``repro.models.registry.init_params``, carried
over by ``repro_torch.bridge``) and the same batches go through
``repro.models.lm.loss_fn`` under ``jax.value_and_grad`` and through the
port's ``models.lm.loss_fn`` under ``torch.autograd``, whose kernels'
``autograd.Function``\\ s run their plain versions on CPU tensors
(``xfer_matmul``'s dgrad/wgrad products, ``flash_attention``'s
``ref.flash_attention_bwd_ref``). Tolerance 2e-4, the fp32 tolerance of
the forward tests: the two sides sum in other orders. The Functions'
own gradients are held to finite differences in fp64
(``torch.autograd.gradcheck``), and a train step's kernel calls are
counted as ``chip_smoke.py`` phase 6 expects them on the card.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import registry as JREG
from repro.optim import adamw as JOPT
from repro.runtime.driver import DriverConfig as JDriverConfig
from repro.runtime.driver import TrainDriver as JTrainDriver
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import xfer_matmul as XM
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import registry as REG
from repro_torch.optim import adamw as OPT
from repro_torch.runtime.driver import DriverConfig, TrainDriver

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its module level imports no torch or jax)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH_ID = "qwen1.5-0.5b"
SHAPE = (32, 4)  # seq, batch


@pytest.fixture(scope="module")
def pair():
    arch_j = jax_get_arch(ARCH_ID).reduced()
    arch = get_arch(ARCH_ID).reduced()
    params = JREG.init_params(arch_j, jax.random.PRNGKey(0), jnp.float32)
    return arch_j, params, arch


def _model(arch, params):
    return bridge.from_jax_params(jax.tree.map(np.asarray, params), arch,
                                  device="cpu")


def _batch(seed=0, seq=SHAPE[0], batch=SHAPE[1]):
    arch = get_arch(ARCH_ID).reduced()
    return TokenPipeline(arch, ShapeConfig("t", seq, batch, "train"),
                         seed=seed).next_batch()


def test_matmul_function_gradcheck():
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.standard_normal((5, 7)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((7, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(XM.xfer_matmul, (x, w))
    # a transposed view as w (the tied unembedding's embed.T)
    e = torch.tensor(rng.standard_normal((3, 7)), requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, e: XM.xfer_matmul(x, e.T),
                                    (x, e))


def test_attention_function_gradcheck():
    rng = np.random.RandomState(1)
    q, k, v = (torch.tensor(rng.standard_normal((2, 6, 4)),
                            requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(FA.flash_attention, (q, k, v))


def test_matmul_function_launches_only_under_grad():
    """Serving (no grad) never enters the Function; training does, and
    its backward is two more products."""
    x = torch.randn(4, 8)
    w = torch.randn(8, 3, requires_grad=True)
    with torch.no_grad():
        assert XM.xfer_matmul(x, w).grad_fn is None
    out = XM.xfer_matmul(x, w)
    assert type(out.grad_fn).__name__ == "_MatmulBackward"


def test_attention_backward_plain_matches_jax():
    """The plain backward (from lse and delta, the kernel's algorithm)
    against jax.grad of the JAX attention oracle."""
    rng = np.random.RandomState(2)
    q, k, v, g = (rng.standard_normal((3, 40, 16)).astype(np.float32)
                  for _ in range(4))

    def f(q, k, v):
        return jnp.sum(JREF.flash_attention_ref(q, k, v, causal=True) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    out, lse = ops.attention_lse_ref(qt, kt, vt)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JREF.flash_attention_ref(q, k, v)), **TOL)
    got = ops.attention_bwd_ref(qt, kt, vt, out, torch.tensor(g), lse)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("form", [dict(window=4), dict(prefix_len=3),
                                  dict(kv_len=True), dict(int8=True)],
                         ids=["window", "prefix_len", "kv_len", "int8"])
def test_attention_forms_without_backward_raise(form):
    q = torch.randn(2, 8, 16, requires_grad=True)
    k, v = torch.randn(2, 8, 16), torch.randn(2, 8, 16)
    kw = {}
    if form.get("kv_len"):
        kw["kv_len"] = torch.full((2,), 8, dtype=torch.int32)
    elif form.get("int8"):
        k = torch.zeros(2, 8, 16, dtype=torch.int8)
        v = torch.zeros(2, 8, 16, dtype=torch.int8)
        kw = dict(k_scale=torch.ones(2, 8, 1), v_scale=torch.ones(2, 8, 1))
    else:
        kw = form
    with pytest.raises(NotImplementedError, match="A12b"):
        FA.flash_attention(q, k, v, **kw)
    with torch.no_grad():  # serving takes every form
        FA.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("t", [8, 12], ids=["causal=False", "cross"])
def test_attention_forms_with_backward_match_jax(t):
    """The forms that train since the encdec family does: non-causal
    self-attention (the encoder) and S queries over T != S keys (the
    cross-attention) go through the Function, and their gradients equal
    jax.grad of the JAX attention oracle."""
    rng = np.random.RandomState(6)
    q, g = (rng.standard_normal((2, 8, 16)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((2, t, 16)).astype(np.float32)
            for _ in range(2))

    def f(q, k, v):
        return jnp.sum(JREF.flash_attention_ref(q, k, v, causal=False) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = FA.flash_attention(qt, kt, vt, causal=False)
    assert type(out.grad_fn).__name__ == "_AttentionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("case", ["plain", "mask", "chunked"])
def test_loss_and_grads_match_jax(pair, case):
    arch_j, params, arch = pair
    b = _batch(seed=3)
    tokens, labels = b["tokens"], b["labels"]
    mask = None
    if case == "mask":
        mask = (np.random.RandomState(4).rand(*tokens.shape) > 0.3
                ).astype(np.float32)
    chunk = 8 if case == "chunked" else 512  # S = 32: 4 chunks

    def f(p):
        return JLM.loss_fn(arch_j, p, jnp.asarray(tokens), jnp.asarray(labels),
                           mask=None if mask is None else jnp.asarray(mask))

    lj, gj = jax.value_and_grad(f)(params)
    model = _model(arch, params)
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    loss = LM.loss_fn(model, torch.from_numpy(tokens),
                      torch.from_numpy(labels),
                      None if mask is None else torch.from_numpy(mask),
                      chunk=chunk)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(lj), **TOL)
    want = bridge.from_jax_tree(jax.tree.map(np.asarray, gj), arch)
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_cross_entropy_chunked_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    y = rng.randint(0, 40, size=(2, 12)).astype(np.int32)
    m = (rng.rand(2, 12) > 0.5).astype(np.float32)
    for chunk in (512, 5, 4):  # 12 positions: one chunk, 4 (5 -> 4), 3
        want = JL.cross_entropy_chunked(jnp.asarray(w), jnp.asarray(x),
                                        jnp.asarray(y), jnp.asarray(m),
                                        chunk=chunk)
        got = L.cross_entropy_chunked(torch.tensor(w), torch.tensor(x),
                                      torch.tensor(y), torch.tensor(m),
                                      chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("arch_id", ["recurrentgemma-2b", "xlstm-350m",
                                     "paligemma-3b"])
def test_non_dense_family_raises(arch_id):
    """The families whose backward kernels are not ported (the MoE and
    encdec families train: tests/test_torch_train_families.py)."""
    arch = get_arch(arch_id).reduced()
    with pytest.raises(NotImplementedError, match="A12b"):
        LM.check_trainable(arch)
    with pytest.raises(NotImplementedError, match="A12b"):
        REG.build_train_step(arch, OPT.AdamWConfig())
    model = REG.init_params(arch, 0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A12b"):
        LM.loss_fn(model, toks, toks)


def test_serving_models_keep_requires_grad_off(pair):
    arch_j, params, arch = pair
    model = _model(arch, params)
    assert not any(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in
                   REG.init_params(arch, 0, device="cpu").parameters())
    # a train step turns it on for its own model only
    step = REG.build_train_step(arch, OPT.AdamWConfig())
    other = _model(arch, params)
    step(model, OPT.adamw_init(model, OPT.AdamWConfig()), _batch())
    assert all(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in other.parameters())


def _count_calls(monkeypatch):
    """Count the kernel wrappers' calls (on the CPU the plain versions):
    each is one launch on the card."""
    calls = {"xfer_matmul": 0, "flash_attention": 0,
             "flash_attention_bwd": 0}

    def counted(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, attr, wrapper)

    counted(XM, "_product", "xfer_matmul")
    counted(FA, "flash_attention_lse", "flash_attention")
    counted(FA, "flash_attention_bwd", "flash_attention_bwd")
    return calls


@pytest.mark.parametrize("seq,chunk,accum", [(32, 512, 1), (32, 8, 1),
                                             (32, 512, 2)])
def test_train_step_kernel_calls(pair, monkeypatch, seq, chunk, accum):
    """A step's kernel calls, forward + remat forward + backward, equal
    chip_smoke.train_launches (phase 6's exact launch counts)."""
    arch_j, params, arch = pair
    model = _model(arch, params)
    cfg = OPT.AdamWConfig()
    step = REG.build_train_step(arch, cfg, accum_steps=accum)
    opt = OPT.adamw_init(model, cfg)
    monkeypatch.setitem(LM.loss_fn.__kwdefaults__, "chunk", chunk)
    calls = _count_calls(monkeypatch)
    step(model, opt, _batch(seq=seq))
    assert calls == chip_smoke.train_launches(arch.num_layers, seq, chunk,
                                              accum)


def _jax_driver(arch_j, params, tmp, accum, schedule):
    cfg = JOPT.AdamWConfig(lr=1e-3)
    step = jax.jit(JREG.build_train_step(arch_j, cfg, lr_schedule=schedule,
                                         accum_steps=accum))
    return JTrainDriver(step, params, JOPT.adamw_init(params, cfg),
                        JPipeline(arch_j, JShape("t", *SHAPE, "train"),
                                  seed=1),
                        JCheckpointer(tmp / "jax", async_save=False),
                        JDriverConfig(total_steps=3, checkpoint_every=2))


@pytest.mark.parametrize("accum", [1, 2])
def test_driver_trajectory_matches_jax(pair, tmp_path, accum):
    arch_j, params, arch = pair
    jd = _jax_driver(arch_j, params, tmp_path, accum,
                     JOPT.cosine_schedule(1e-3, warmup=1, total=3))
    want = [m["loss"] for m in jd.run()["log"]]
    model = _model(arch, params)
    cfg = OPT.AdamWConfig(lr=1e-3)
    step = REG.build_train_step(arch, cfg,
                                OPT.cosine_schedule(1e-3, warmup=1, total=3),
                                accum_steps=accum)
    d = TrainDriver(step, model, OPT.adamw_init(model, cfg),
                    TokenPipeline(arch, ShapeConfig("t", *SHAPE, "train"),
                                  seed=1),
                    Checkpointer(tmp_path / "port", async_save=False),
                    DriverConfig(total_steps=3, checkpoint_every=2))
    got = [m["loss"] for m in d.run()["log"]]
    assert len(got) == 3 and got[0] != got[2]
    np.testing.assert_allclose(got, want, **TOL)


def test_grad_accumulation_matches_full_batch(pair):
    """accum=2 gives the full batch's update (a token-mean CE composes
    linearly over equal microbatches)."""
    arch_j, params, arch = pair
    cfg = OPT.AdamWConfig(lr=1e-3)
    batch = _batch(seed=4)
    out = []
    for accum in (1, 2):
        model = _model(arch, params)
        _, _, m = REG.build_train_step(arch, cfg, accum_steps=accum)(
            model, OPT.adamw_init(model, cfg), batch)
        out.append((float(m["loss"]), model.state_dict()))
    assert np.isclose(out[0][0], out[1][0], rtol=1e-5)
    for name, a in out[0][1].items():
        np.testing.assert_allclose(a.numpy(), out[1][1][name].numpy(),
                                   rtol=1e-4, atol=5e-5, err_msg=name)


def test_loss_decreases_over_training(pair):
    arch_j, params, arch = pair
    model = _model(arch, params)
    cfg = OPT.AdamWConfig(lr=1e-3)
    step = REG.build_train_step(arch, cfg)
    opt = OPT.adamw_init(model, cfg)
    pipe = TokenPipeline(arch, ShapeConfig("t", *SHAPE, "train"), seed=0)
    losses = [float(step(model, opt, pipe.next_batch())[2]["loss"])
              for _ in range(12)]
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    result = train.main(["--device", "cpu", "--steps", "3", "--seq", "16",
                         "--batch", "2", "--ckpt", str(tmp_path / "ck")])
    assert result["final_step"] == 3 and len(result["log"]) == 3
    assert "[train] 3 steps" in capsys.readouterr().out
    # the same directory resumes at the end: nothing left to run
    assert train.main(["--device", "cpu", "--steps", "3", "--seq", "16",
                       "--batch", "2", "--ckpt", str(tmp_path / "ck")]
                      )["log"] == []
    with pytest.raises(NotImplementedError, match="A13"):
        train.main(["--device", "cpu", "--xfer", "on", "--ckpt",
                    str(tmp_path / "x")])
