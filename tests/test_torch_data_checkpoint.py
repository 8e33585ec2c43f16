"""The port's data pipeline, checkpoints and fault-tolerant driver, on the
CPU: mirrors of the reference's ``tests/test_data_checkpoint.py`` and of
the driver tests of ``tests/test_system.py``, plus batches bit-equal to
the JAX package's pipeline for one ``.reduced()`` arch of the dense,
vlm and encdec families, and bf16 and int8 leaves through a checkpoint.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import TokenPipeline as JPipeline
from repro_torch import quant as Q
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.models import registry as REG
from repro_torch.optim import adamw as OPT
from repro_torch.runtime.driver import (DriverConfig, StragglerMonitor,
                                        TrainDriver)

ARCH = get_arch("qwen1.5-0.5b").reduced()
SHAPE = ShapeConfig("t", 32, 8, "train")


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "paligemma-3b",
                                     "seamless-m4t-medium"])
def test_pipeline_bit_equal_to_jax(arch_id):
    shape = (48, 4)
    for hosts, host in ((1, 0), (2, 1)):
        p = TokenPipeline(get_arch(arch_id).reduced(),
                          ShapeConfig("t", *shape, "train"), seed=11,
                          host_index=host, host_count=hosts)
        pj = JPipeline(jax_get_arch(arch_id).reduced(),
                       JShape("t", *shape, "train"), seed=11,
                       host_index=host, host_count=hosts)
        for _ in range(2):
            got, want = p.next_batch(), pj.next_batch()
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = set(got)
    assert keys == {"tokens", "labels"} | (
        {"patches"} if arch_id == "paligemma-3b" else set()) | (
        {"frames"} if arch_id == "seamless-m4t-medium" else set())


def test_pipeline_deterministic_replay():
    p1 = TokenPipeline(ARCH, SHAPE, seed=7)
    ref = [p1.next_batch() for _ in range(3)]
    p2 = TokenPipeline(ARCH, SHAPE, seed=7)
    p2.state.step = 2
    np.testing.assert_array_equal(p2.next_batch()["tokens"], ref[2]["tokens"])


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
@pytest.mark.parametrize("step", [0, 3])
def test_pipeline_host_sharding_partitions_global_stream(hosts, step):
    global_pipe = TokenPipeline(ARCH, SHAPE, seed=3)
    global_pipe.state.step = step
    ref = global_pipe.next_batch()["tokens"]
    rows = []
    for h in range(hosts):
        p = TokenPipeline(ARCH, SHAPE, seed=3, host_index=h, host_count=hosts)
        p.state.step = step
        rows.append(p.next_batch()["tokens"])
    np.testing.assert_array_equal(np.concatenate(rows, axis=0), ref)


def test_pipeline_labels_shift():
    b = TokenPipeline(ARCH, SHAPE, seed=0).next_batch()
    assert b["tokens"].shape == b["labels"].shape == (8, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_state_serialization():
    st = PipelineState(step=42)
    assert PipelineState.from_dict(json.loads(json.dumps(st.to_dict()))).step == 42


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32),
                  "h": torch.linspace(-3, 3, 5).to(torch.bfloat16),
                  "m": Q.quantize(torch.linspace(-1, 1, 7))},
            "step": torch.tensor(3, dtype=torch.int32)}


def _like():
    return {"a": torch.zeros((2, 3)),
            "b": {"c": torch.zeros((4,), dtype=torch.int32),
                  "h": torch.zeros(5, dtype=torch.bfloat16),
                  "m": Q.QTensor(torch.zeros(7, dtype=torch.int8),
                                 torch.zeros(()))},
            "step": torch.tensor(0, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_keep(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=False)
    tree = _tree()
    for step in (10, 20, 30):
        ck.save(step, tree, extra={"data_step": step})
    assert ck.available_steps() == [20, 30]  # keep-2 GC
    assert (tmp_path / "LATEST").read_text() == "step_000000030"
    idx = json.loads((tmp_path / "step_000000030" / "index.json").read_text())
    dtypes = {leaf["key"]: leaf["dtype"] for leaf in idx["leaves"]}
    assert dtypes["b/h"] == "bfloat16" and dtypes["b/m/q"] == "int8"
    assert dtypes["b/m/scale"] == "float32"
    like = _like()
    live = like["b"]["h"]
    restored, extra, step = ck.restore(like)
    assert step == 30 and extra["data_step"] == 30
    assert restored is like and like["b"]["h"] is live  # in place
    for (k, a), (_, b) in zip(_flat(restored), _flat(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def _flat(tree, prefix=""):
    from repro_torch.checkpoint.checkpointer import flatten
    return flatten(tree, prefix)


def test_checkpoint_corruption_fallback(tmp_path):
    ck = Checkpointer(tmp_path, keep=3, async_save=False)
    tree = {"a": torch.ones((2, 2))}
    ck.save(1, tree)
    ck.save(2, {"a": torch.full((2, 2), 2.0)})
    (pathlib.Path(tmp_path) / "step_000000002" / "index.json").write_text("{broken")
    like = {"a": torch.zeros((2, 2))}
    restored, _, step = ck.restore(like)
    assert step == 1 and restored is not None
    assert torch.equal(like["a"], torch.ones((2, 2)))


def test_checkpoint_skips_mismatched_leaves(tmp_path):
    """A step whose leaves do not match the live tree's shapes or dtypes
    is skipped, and nothing is copied from it."""
    ck = Checkpointer(tmp_path, keep=3, async_save=False)
    ck.save(1, {"a": torch.ones((2, 2)), "b": torch.ones(3)})
    ck.save(2, {"a": torch.full((2, 2), 2.0), "b": torch.ones(4)})
    ck.save(3, {"a": torch.full((2, 2), 3.0),
                "b": torch.ones(3, dtype=torch.bfloat16)})
    like = {"a": torch.zeros((2, 2)), "b": torch.zeros(3)}
    _, _, step = ck.restore(like)
    assert step == 1 and torch.equal(like["a"], torch.ones((2, 2)))
    assert ck.restore({"z": torch.zeros(1)}) == (None, None, -1)


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(tmp_path, keep=1, async_save=True)
    x = torch.zeros(8)
    ck.save(5, {"a": x})
    x += 1  # the save holds a snapshot, not the live tensor
    ck.wait()
    assert ck.available_steps() == [5]
    like = {"a": torch.ones(8)}
    ck.restore(like)
    assert torch.equal(like["a"], torch.zeros(8))


def _setup(seed=0, quantize=False):
    model = REG.init_params(ARCH, seed, device="cpu")
    cfg = OPT.AdamWConfig(lr=1e-3, quantize=quantize)
    return model, OPT.adamw_init(model, cfg), REG.build_train_step(ARCH, cfg)


def _leaves(model, opt):
    from repro_torch.checkpoint.checkpointer import flatten
    return flatten({"params": model.state_dict(), "opt": opt})


@pytest.mark.parametrize("quantize", [False, True])
def test_driver_restart_resumes_exactly(tmp_path, quantize):
    """Kill the step mid-run; the driver restores and ends in the state of
    an uninterrupted run (deterministic replay), params and AdamW state
    bit-equal."""
    shape = ShapeConfig("t", 16, 4, "train")
    m1, o1, step = _setup(quantize=quantize)
    d1 = TrainDriver(step, m1, o1, TokenPipeline(ARCH, shape, seed=1),
                     Checkpointer(tmp_path / "a", keep=5, async_save=False),
                     DriverConfig(total_steps=6, checkpoint_every=2))
    d1.run()
    m2, o2, step2 = _setup(quantize=quantize)
    calls = {"n": 0}

    def flaky(m, o, b):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("injected device failure")
        return step2(m, o, b)

    d2 = TrainDriver(flaky, m2, o2, TokenPipeline(ARCH, shape, seed=1),
                     Checkpointer(tmp_path / "b", keep=5, async_save=False),
                     DriverConfig(total_steps=6, checkpoint_every=2))
    assert d2.run()["restarts"] == 1
    for (k, a), (_, b) in zip(_leaves(m1, o1), _leaves(m2, o2)):
        assert torch.equal(a, b), k


def test_driver_resumes_from_its_directory(tmp_path):
    """A second driver on the same directory restores the last save and
    has nothing left to run; its params and state equal the saved ones."""
    shape = ShapeConfig("t", 16, 4, "train")
    m1, o1, step = _setup()
    TrainDriver(step, m1, o1, TokenPipeline(ARCH, shape, seed=2),
                Checkpointer(tmp_path), DriverConfig(total_steps=4,
                                                     checkpoint_every=2)).run()
    m2, o2, step2 = _setup(seed=9)
    d2 = TrainDriver(step2, m2, o2, TokenPipeline(ARCH, shape, seed=2),
                     Checkpointer(tmp_path), DriverConfig(total_steps=4))
    assert d2.run()["log"] == [] and d2.pipeline.state.step == 4
    for (k, a), (_, b) in zip(_leaves(m1, o1), _leaves(m2, o2)):
        assert torch.equal(a, b), k


def test_driver_restarts_on_non_finite_loss(tmp_path):
    shape = ShapeConfig("t", 16, 4, "train")
    model, opt, step = _setup()
    calls = {"n": 0}

    def blowup(m, o, b):
        calls["n"] += 1
        m, o, metrics = step(m, o, b)
        if calls["n"] == 3:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return m, o, metrics

    d = TrainDriver(blowup, model, opt, TokenPipeline(ARCH, shape),
                    Checkpointer(tmp_path, async_save=False),
                    DriverConfig(total_steps=4, checkpoint_every=2))
    r = d.run()
    assert r["restarts"] == 1
    assert [m["step"] for m in r["log"]] == [0, 1, 2, 3]


def test_driver_gives_up_after_max_restarts(tmp_path):
    model, opt, _ = _setup()

    def always_fail(m, o, b):
        raise RuntimeError("dead")

    d = TrainDriver(always_fail, model, opt, TokenPipeline(ARCH, SHAPE),
                    Checkpointer(tmp_path, async_save=False),
                    DriverConfig(total_steps=4, max_restarts=2))
    with pytest.raises(RuntimeError, match="max_restarts"):
        d.run()
    assert d.restarts == 3


def test_driver_plan_construction_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="A13"):
        TrainDriver(object())


def test_straggler_monitor_detects_outlier():
    m = StragglerMonitor(warmup=3)
    for _ in range(6):
        assert not m.observe(0.1)
    assert m.observe(1.0)
    assert m.events == 1


def test_straggler_restart_rebuilds_the_step(tmp_path, monkeypatch):
    """A run of straggler steps checkpoints and rebuilds the step
    function (the step's wall clock from a fake clock: 0.1 s a step, 1 s
    for steps 3-5)."""
    from repro_torch.runtime import driver as DRV
    model, opt, step = _setup()
    durations = iter([0.1] * 3 + [1.0] * 3 + [0.1] * 4)

    class Clock:
        now = 0.0
        pending = None

        @classmethod
        def time(cls):
            if cls.pending is None:  # a step starts
                cls.pending = next(durations)
                return cls.now
            cls.now += cls.pending
            cls.pending = None
            return cls.now

    monkeypatch.setattr(DRV, "time", Clock)
    rebuilt = []

    def rebuild():
        rebuilt.append(len(rebuilt))
        return step

    d = TrainDriver(step, model, opt, TokenPipeline(ARCH, SHAPE),
                    Checkpointer(tmp_path, async_save=False),
                    DriverConfig(total_steps=8, checkpoint_every=100,
                                 straggler_restart_after=2),
                    on_failure_rebuild=rebuild)
    d.monitor = StragglerMonitor(warmup=3)
    d.run()
    assert rebuilt == [0] and d.monitor.events == 3
    assert Checkpointer(tmp_path).available_steps() == [4, 8]  # 4: the restart
