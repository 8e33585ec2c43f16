"""Training of the MoE and encdec families (deepseek-moe-16b and
seamless-m4t-medium, ``.reduced()``) against the JAX package, fp32 on
the CPU.

The same seeded weights (``repro.models.registry.init_params``, carried
over by ``repro_torch.bridge``) and the same batches go through
``jax.value_and_grad`` of ``repro.models.lm.loss_fn`` (MoE) or
``repro.models.encdec.loss_fn`` (encdec) and through the port's
``models.lm.loss_fn`` or ``models.encdec.loss_fn`` under
``torch.autograd``, whose kernels' ``autograd.Function``\\ s run their
plain versions on CPU tensors: ``xfer_matmul_experts``' data and weight
gradients (``ref.expert_matmul_dgrad_ref``, ``ref.expert_matmul_wgrad_ref``)
and ``flash_attention``'s non-causal and cross backward
(``ref.flash_attention_bwd_ref``). Tolerance 2e-4, the fp32 tolerance of
the forward tests: the two sides sum in other orders.

Also: the expert gradients' plain versions against ``jax.vjp`` of the
reference's einsum with experts that hold no live row; the plain
backward of the non-causal and the S != T forms against ``jax.grad`` of
the reference's attention; ``TrainDriver`` loss trajectories against the
JAX driver, fp32 and int8 AdamW state; a checkpoint round trip through
a second driver; the kernel calls of a step, as ``chip_smoke.py``'s
phases 6c and 6d count them on the card.
"""
import dataclasses
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
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro.models import registry as JREG
from repro.optim import adamw as JOPT
from repro.runtime.driver import DriverConfig as JDriverConfig
from repro.runtime.driver import TrainDriver as JTrainDriver
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import xfer_matmul as XM
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models import moe as M
from repro_torch.models import registry as REG
from repro_torch.optim import adamw as OPT
from repro_torch.runtime.driver import DriverConfig, TrainDriver

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its module level imports no torch or jax)

TOL = dict(rtol=2e-4, atol=2e-4)
MOE, ENCDEC = "deepseek-moe-16b", "seamless-m4t-medium"
SHAPE = (16, 4)  # seq, batch
#: the reduced MoE config's dropless capacity factor, and one that drops
FACTORS = {"dropless": None, "dropping": 1.25}


def _archs(arch_id, factor=None):
    arch_j, arch = jax_get_arch(arch_id).reduced(), get_arch(arch_id).reduced()
    if factor is not None:
        arch_j = dataclasses.replace(arch_j, moe_capacity_factor=factor)
        arch = dataclasses.replace(arch, moe_capacity_factor=factor)
    return arch_j, arch


@pytest.fixture(scope="module")
def params():
    """Seeded fp32 JAX params of each family's reduced config."""
    return {a: JREG.init_params(jax_get_arch(a).reduced(),
                                jax.random.PRNGKey(0), jnp.float32)
            for a in (MOE, ENCDEC)}


def _model(arch, tree):
    return bridge.from_jax_params(jax.tree.map(np.asarray, tree), arch,
                                  device="cpu")


def _batch(arch, seed=0, seq=SHAPE[0], batch=SHAPE[1]):
    return TokenPipeline(arch, ShapeConfig("t", seq, batch, "train"),
                         seed=seed).next_batch()


def _jax_loss(arch_j, p, b):
    if arch_j.family == "encdec":
        return JED.loss_fn(arch_j, p, jnp.asarray(b["frames"]),
                           jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    return JLM.loss_fn(arch_j, p, jnp.asarray(b["tokens"]),
                       jnp.asarray(b["labels"]))


def _port_loss(model, b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    if model.arch.family == "encdec":
        return ED.loss_fn(model, t["frames"], t["tokens"], t["labels"])
    return LM.loss_fn(model, t["tokens"], t["labels"])


def _check_loss_and_grads(arch_j, arch, tree, b):
    lj, gj = jax.value_and_grad(lambda p: _jax_loss(arch_j, p, b))(tree)
    model = _model(arch, tree)
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    loss = _port_loss(model, b)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(lj), **TOL)
    want = bridge.from_jax_tree(jax.tree.map(np.asarray, gj), arch)
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    return names


@pytest.mark.parametrize("case", list(FACTORS))
def test_moe_loss_and_grads_match_jax(params, case):
    """Every gradient of reduced deepseek-moe-16b (a dense prefix layer,
    an MoE layer with a shared expert, the router included) as is
    (capacity factor 8: nothing dropped) and at factor 1.25, where
    assignments drop to the spare row and get no gradient."""
    arch_j, arch = _archs(MOE, FACTORS[case])
    b = _batch(arch, seed=3)
    kept = []
    dispatch = M.dispatch

    def recorded(*a):
        out = dispatch(*a)
        kept.append(out[2])
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "dispatch", recorded)
        names = _check_loss_and_grads(arch_j, arch, params[MOE], b)
    dropped = int((~kept[0]).sum())
    assert dropped > 0 if case == "dropping" else dropped == 0
    assert any(".router" in n for n in names)
    assert any(".moe.w_gate" in n for n in names)


def test_encdec_loss_and_grads_match_jax(params):
    """Every gradient of reduced seamless-m4t-medium: the encoder
    (bidirectional attention), the decoder (causal self-attention,
    cross-attention over the encoder output), the norms and the
    unembedding."""
    arch_j, arch = _archs(ENCDEC)
    names = _check_loss_and_grads(arch_j, arch, params[ENCDEC],
                                  _batch(arch, seed=4))
    assert any(n.startswith("enc_layers.") for n in names)
    assert any(".xwk" in n for n in names)


def _expert_case(seed):
    rng = np.random.RandomState(seed)
    e, c, k, n = 5, 7, 6, 4
    counts = np.array([7, 0, 3, 1, 0], np.int32)  # two experts hold no row
    live = np.arange(c)[None, :] < counts[:, None]
    x = rng.standard_normal((e, c, k)).astype(np.float32) * live[..., None]
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    dy = rng.standard_normal((e, c, n)).astype(np.float32) * live[..., None]
    return x, w, dy, counts


def test_expert_grads_plain_match_jax_vjp():
    """The plain dgrad and wgrad of the expert products (rows past each
    expert's count zero in x and dy, as the MoE layer leaves them)
    against ``jax.vjp`` of the reference's ``einsum("ecd,edf->ecf")``;
    an expert with no live row gets dx = 0 and dw = 0."""
    x, w, dy, counts = _expert_case(0)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    ct = torch.tensor(counts)
    dx = ops.expert_matmul_dgrad_ref(torch.tensor(dy), torch.tensor(w), ct)
    dw = ops.expert_matmul_wgrad_ref(torch.tensor(x), torch.tensor(dy), ct)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)
    assert not dw[1].any() and not dw[4].any()
    # the Function's backward (the wrapper on CPU tensors) gives the same
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = XM.xfer_matmul_experts(xt, wt, ct)
    assert type(out.grad_fn).__name__ == "_ExpertMatmulBackward"
    gx, gw = torch.autograd.grad(out, (xt, wt), torch.tensor(dy))
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


def test_expert_function_gradcheck():
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.standard_normal((3, 5, 4)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((3, 4, 6)), requires_grad=True)
    counts = torch.tensor([5, 0, 2], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda x, w: XM.xfer_matmul_experts(x, w, counts), (x, w))
    assert torch.autograd.gradcheck(XM.xfer_matmul_experts, (x, w))
    with torch.no_grad():  # serving never enters the Function
        assert XM.xfer_matmul_experts(x, w, counts).grad_fn is None


@pytest.mark.parametrize("s,t", [(24, 24), (20, 33)],
                         ids=["noncausal", "cross"])
def test_attention_backward_plain_forms_match_jax(s, t):
    """The plain backward of the non-causal form (the encoder) and of S
    queries over T != S keys (the cross-attention), from lse and delta,
    against jax.grad of the JAX attention oracle."""
    rng = np.random.RandomState(2)
    q, g = (rng.standard_normal((3, s, 16)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((3, t, 16)).astype(np.float32)
            for _ in range(2))

    def f(q, k, v):
        return jnp.sum(JREF.flash_attention_ref(q, k, v, causal=False) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    out, lse = ops.attention_lse_ref(qt, kt, vt, causal=False)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(JREF.flash_attention_ref(q, k, v,
                                                         causal=False)), **TOL)
    got = ops.attention_bwd_ref(qt, kt, vt, out, torch.tensor(g), lse,
                                causal=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_bwd_plan_cross_and_noncausal():
    """``bwd_plan`` over T != S keys, non-causal: dkdv's items are the
    key blocks, each visiting every query tile; dq's the query blocks,
    each visiting every key tile; both schedules take each item once."""
    p = FA.bwd_plan(16, 256, 64, 132, t=512, causal=False)
    assert p["items"] == 16 * 4 and p["dq_items"] == 16 * 2
    assert p["dkdv_tiles"] == [4] * 64 and p["dq_tiles"] == [8] * 32
    for items, blocks in ((p["items"], p["block_items"]),
                          (p["dq_items"], p["dq_block_items"])):
        assert sorted(i for b in blocks for i in b) == list(range(items))
    causal = FA.bwd_plan(2, 100, 64, 132, t=300)  # keys past S see nothing
    assert causal["dkdv_tiles"][-2:] == [0, 0]


def _recording(step, states, to_port):
    """``step`` that also keeps, a step, the int8 payloads of the AdamW
    state it returns and the params it updated (``to_port``: a tree as
    port names -> tensor or QTensor)."""
    def fn(params, opt_state, batch):
        out = step(params, opt_state, batch)
        states.append(({(key, n): qt.q.clone() for key in ("m", "v")
                        for n, qt in to_port(out[1][key]).items()},
                       {n: p.detach().clone()
                        for n, p in to_port(out[0]).items()}))
        return out
    return fn


def _jax_driver(arch_j, arch, tree, tmp, quantize, states):
    cfg = JOPT.AdamWConfig(lr=1e-3, quantize=quantize)
    step = jax.jit(JREG.build_train_step(
        arch_j, cfg, lr_schedule=JOPT.cosine_schedule(1e-3, warmup=1,
                                                      total=3)))
    if quantize:
        step = _recording(step, states, lambda t: bridge.from_jax_tree(
            jax.tree.map(np.asarray, t), arch))
    return JTrainDriver(step, tree, JOPT.adamw_init(tree, cfg),
                        JPipeline(arch_j, JShape("t", *SHAPE, "train"),
                                  seed=1),
                        JCheckpointer(tmp / "jax", async_save=False),
                        JDriverConfig(total_steps=3, checkpoint_every=2))


def _port_driver(arch, model, tmp, quantize, steps=3, seed=1, states=None):
    cfg = OPT.AdamWConfig(lr=1e-3, quantize=quantize)
    step = REG.build_train_step(arch, cfg, OPT.cosine_schedule(
        1e-3, warmup=1, total=3))
    if states is not None:
        step = _recording(step, states, lambda t: t if isinstance(t, dict)
                          else dict(t.named_parameters()))
    return TrainDriver(step, model, OPT.adamw_init(model, cfg),
                       TokenPipeline(arch, ShapeConfig("t", *SHAPE, "train"),
                                     seed=seed),
                       Checkpointer(tmp, async_save=False),
                       DriverConfig(total_steps=steps, checkpoint_every=2))


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("arch_id", [MOE, ENCDEC])
def test_driver_trajectory_matches_jax(params, tmp_path, arch_id, quantize):
    """Three driver steps (cosine schedule, a checkpoint at step 2) give
    the JAX driver's losses, with fp32 and with int8 AdamW state (one
    scale per stacked leaf: the MoE dense prefix layer alone, the body's
    layers together; the encoder's and the decoder's stacks).

    int8: a step entered with the reference's params (within 2e-4) gives
    its loss within 2e-4 and payloads of m and v within one level of the
    reference's (the two sides' fp32 gradients differ in summation
    order, which can move a value across a rounding boundary). A v
    payload one level apart where the reference's per-tensor int8 v
    rounds to 0 changes that element's update by up to ``m / eps``, so
    the params after it part and the later steps are not compared; the
    first two steps are, at least."""
    arch_j, arch = _archs(arch_id)
    want_states, got_states = [], []
    want = [m["loss"] for m in _jax_driver(
        arch_j, arch, params[arch_id], tmp_path, quantize,
        want_states).run()["log"]]
    got = [m["loss"] for m in _port_driver(
        arch, _model(arch, params[arch_id]), tmp_path / "port", quantize,
        states=got_states if quantize else None).run()["log"]]
    assert len(got) == 3 and got[0] != got[2]
    if not quantize:
        np.testing.assert_allclose(got, want, **TOL)
        return
    assert len(want_states) == len(got_states) == 3
    close = [True]  # step k entered with the reference's params
    for k, ((w, wp), (g, gp)) in enumerate(zip(want_states, got_states)):
        assert set(w) == set(g) and set(wp) == set(gp)
        if close[k]:  # payloads out within one level
            for key in w:
                assert int((w[key].int() - g[key].int()).abs().max()) <= 1, \
                    (k, key)
        close.append(close[k] and all(torch.allclose(
            gp[n], wp[n], rtol=TOL["rtol"], atol=TOL["atol"]) for n in wp))
    compared = [k for k in range(3) if close[k]]
    assert len(compared) >= 2
    np.testing.assert_allclose([got[k] for k in compared],
                               [want[k] for k in compared], **TOL)


@pytest.mark.parametrize("arch_id", [MOE, ENCDEC])
def test_checkpoint_round_trip(params, tmp_path, arch_id):
    """A driver saves at step 2 and 4; a second one on the same directory
    (other seeded weights) restores step 4, has nothing left to run, and
    holds the first's params and AdamW state bit-equal."""
    _, arch = _archs(arch_id)
    first = _port_driver(arch, _model(arch, params[arch_id]), tmp_path,
                         quantize=True, steps=4)
    first.run()
    second = _port_driver(arch, REG.init_params(arch, 9, device="cpu"),
                          tmp_path, quantize=True, steps=4)
    assert second.run()["log"] == [] and second.pipeline.state.step == 4
    saved = flatten({"params": first.params.state_dict(),
                     "opt": first.opt_state})
    restored = flatten({"params": second.params.state_dict(),
                        "opt": second.opt_state})
    assert len(saved) == len(restored)
    for (k, a), (_, b) in zip(saved, restored):
        assert torch.equal(a, b), k


def _count_calls(monkeypatch):
    """Count the kernel wrappers' calls (on the CPU the plain versions):
    each is one launch on the card."""
    calls = dict.fromkeys(("xfer_matmul", "xfer_matmul_experts",
                           "flash_attention", "flash_attention_bwd"), 0)

    def counted(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, attr, wrapper)

    counted(XM, "_product", "xfer_matmul")
    counted(XM, "_experts_product", "xfer_matmul_experts")
    counted(XM, "_experts_wgrad", "xfer_matmul_experts")
    counted(FA, "flash_attention_lse", "flash_attention")
    counted(FA, "flash_attention_bwd", "flash_attention_bwd")
    return calls


@pytest.mark.parametrize("arch_id", [MOE, ENCDEC])
def test_train_step_kernel_calls(params, monkeypatch, arch_id):
    """A step's kernel calls, forward + remat forward + backward, equal
    ``chip_smoke.moe_train_launches`` / ``encdec_train_launches``
    (phases 6c and 6d's exact launch counts)."""
    _, arch = _archs(arch_id)
    model = _model(arch, params[arch_id])
    cfg = OPT.AdamWConfig()
    step = REG.build_train_step(arch, cfg)
    opt = OPT.adamw_init(model, cfg)
    calls = _count_calls(monkeypatch)
    step(model, opt, _batch(arch))
    if arch_id == MOE:
        want = chip_smoke.moe_train_launches(
            arch.first_dense_layers, arch.num_layers - arch.first_dense_layers,
            SHAPE[0])
    else:
        want = chip_smoke.encdec_train_launches(arch.enc_layers,
                                                arch.dec_layers, SHAPE[0])
    assert calls == want


def test_expert_grad_routes():
    """The launch plans of the expert gradients on an H100 (132 SMs):
    the dgrad's K-major ``w.T`` takes ``wgmma``'s 128-row tiles (the
    64-row expert tile reads a row-major ``w`` only) or, small, ``tc``;
    the wgrad (``kdepth``: the contraction bounded on the card) takes
    ``wgmma`` for bf16 on 16-byte rows, ``tile`` for fp32 or C off 8."""
    bf, f32 = torch.bfloat16, torch.float32
    # deepseek's training shapes: C = 240 (and 60), K 2048, N 1408
    for c in (240, 60):
        rt = XM.route(c, 1408, 2048, bf, (1, 1408), 132, experts=64)
        assert (rt.kernel, rt.rows) == ("wgmma", 128)
    assert XM.route(60, 1408, 2048, bf, (1408, 1), 132, experts=64).rows == 64
    assert XM.route(37, 40, 24, bf, (1, 40), 132, experts=5).kernel == "tc"
    wg = XM.route(2048, 240, 1408, bf, (1408, 1), 132, experts=64,
                  kdepth=True)
    assert (wg.kernel, wg.rows, wg.cols) == ("wgmma", 128, 128)
    assert XM.route(24, 37, 40, bf, (40, 1), 132, experts=5,
                    kdepth=True).kernel == "tile"
    assert XM.route(2048, 240, 1408, f32, (1408, 1), 132, experts=64,
                    kdepth=True).kernel == "tile"


@pytest.mark.parametrize("arch_id", [MOE, ENCDEC])
def test_train_cli_on_cpu(tmp_path, capsys, arch_id):
    """``launch.train --arch`` trains both families (reduced), with no
    other flag, and resumes from its directory."""
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--arch", arch_id, "--steps", "2", "--seq",
            "16", "--batch", "2", "--ckpt", str(tmp_path / "ck")]
    result = train.main(argv)
    assert result["final_step"] == 2 and len(result["log"]) == 2
    assert np.isfinite([m["loss"] for m in result["log"]]).all()
    assert "[train] 2 steps" in capsys.readouterr().out
    assert train.main(argv)["log"] == []
