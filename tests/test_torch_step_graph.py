"""The port's decode step at fixed addresses (``serving/captured.py``) on
the CPU, on every serving path, against the JAX package's engines.

On CUDA ``ServingEngine`` replays one captured CUDA graph per step; on
the CPU the same in-place step runs eagerly, which is what these tests
reach. They check what the graph relies on and what it must keep:

* every cache leaf and every ``DecodeState`` field (the sampling keys
  and the speculative draft grid's leaves included) keeps its address
  (``data_ptr``) across the steps and admission waves of a churning run
  (2 slots, 6 requests), on the six greedy serving paths (the fp grid,
  INT8, the paged pool with fp and int8 pools, the hybrid
  recurrentgemma-2b and the ssm xlstm-350m, all ``.reduced()``), top-k
  sampling on the grid, speculative decoding (a 1-layer draft, k = 3) on
  the grid and the pool, the MoE deepseek-moe-16b on the grid and
  the pool (its expert routing inside the step), the encdec
  seamless-m4t-medium (source frames of mixed lengths: the state's
  ``enc_out``/``enc_len`` written at admission, read in the step) and
  the vlm paligemma-3b on the grid and the pool (patched and text-only
  requests mixed), at lookahead 0 and 1,
  and the streams
  still equal the JAX ``ServingEngine``'s with the same configuration on
  the same bridged weights (a divergence names the top-2 logit margin of
  the port's model there);
* the eager step of ``registry.build_serve_step`` on a clone of caches
  and state after an admission and the engine's step on the originals
  give equal records and bit-equal caches and state (phase 4g of
  ``chip_smoke.py`` holds the graph to the same);
* a capture's launch counts are added once per replay, and nothing for
  the capture itself;
* a workspace that a capture holds survives a later, larger
  ``scratch()`` request that replaces it in the cache.
"""
import gc
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as JQ
from repro.configs import get_arch as jax_get_arch
from repro.models import registry as JREG
import dataclasses

from repro.serving import sampler as JS
from repro.serving.config import PagingConfig as JPagingConfig
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.config import SpecConfig as JSpecConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.testing.serving_equiv import _frames, _prompts
from repro_torch import bridge
from repro_torch import quant as Q
from repro_torch.configs import get_arch
from repro_torch.kernels import _launch, ops
from repro_torch.models import registry as REG
from repro_torch.serving import (PagingConfig, Request, SamplingParams,
                                 ServeConfig, ServingEngine, SpecConfig)
from repro_torch.serving import captured as CS
from repro_torch.serving import state as ST

SLOTS, N_REQ, MAX_LEN, MAX_NEW, SEED, PS = 2, 6, 48, 6, 0, 8

#: path -> (arch id, int8, paged, "top_k" (sampled) / "spec" / None)
PATHS = {"fp": ("qwen1.5-0.5b", False, False, None),
         "int8": ("qwen1.5-0.5b", True, False, None),
         "paged": ("qwen1.5-0.5b", False, True, None),
         "paged-int8": ("qwen1.5-0.5b", True, True, None),
         "hybrid": ("recurrentgemma-2b", False, False, None),
         "ssm": ("xlstm-350m", False, False, None),
         "top-k": ("qwen1.5-0.5b", False, False, "top_k"),
         "spec": ("qwen1.5-0.5b", False, False, "spec"),
         "spec-paged": ("qwen1.5-0.5b", False, True, "spec"),
         "moe": ("deepseek-moe-16b", False, False, None),
         "moe-paged": ("deepseek-moe-16b", False, True, None),
         "encdec": ("seamless-m4t-medium", False, False, None),
         "vlm": ("paligemma-3b", False, False, None),
         "vlm-paged": ("paligemma-3b", False, True, None)}
TOP_K = SamplingParams("top_k", 0.8, 5)
SPEC_K = 3


def _liven(tree: dict, seed: int) -> dict:
    """Seeded norms, biases and gate biases and 8x output projections on
    every block, so that greedy streams do not repeat one token."""
    rng = np.random.RandomState(seed)

    def block(b):
        b = dict(b)
        for k in ("ln1", "ln2", "ln_x", "ln_inner", "conv_b", "gate_b", "bq",
                  "bk", "bv", "b_i", "b_f", "b"):
            if k in b:
                b[k] = (0.5 * rng.standard_normal(b[k].shape)).astype(np.float32)
        for k in ("wo", "w_out", "w_down"):
            if k in b:
                b[k] = b[k] * 8.0
        if "mlp" in b:
            b["mlp"] = dict(b["mlp"], w_down=b["mlp"]["w_down"] * 8.0)
        return b

    tree = dict(tree)
    if "body" in tree:
        tree["body"] = {k: block(v) for k, v in tree["body"].items()}
    for k in [k for k in tree if k.startswith("suffix")
              or k in ("enc_body", "dec_body")]:
        tree[k] = block(tree[k])
    return tree


_TREES = {}


def _tree(arch_id):
    if arch_id not in _TREES:
        arch_j = jax_get_arch(arch_id).reduced()
        _TREES[arch_id] = _liven(jax.tree.map(np.asarray, JREG.init_params(
            arch_j, jax.random.PRNGKey(SEED), jnp.float32)), SEED + 1)
    return _TREES[arch_id]


def _draft_archs():
    """The speculative paths' draft: qwen's widths at 1 layer (JAX, port)."""
    return (dataclasses.replace(jax_get_arch("qwen1.5-0.5b").reduced(),
                                num_layers=1),
            dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                                num_layers=1))


def _draft_tree():
    if "draft" not in _TREES:
        _TREES["draft"] = _liven(jax.tree.map(np.asarray, JREG.init_params(
            _draft_archs()[0], jax.random.PRNGKey(SEED + 5), jnp.float32)),
            SEED + 2)
    return _TREES["draft"]


def _prompts_for(arch_id):
    return _prompts(jax_get_arch(arch_id).reduced(), N_REQ, MAX_LEN, SEED + 1,
                    MAX_NEW)


def _payloads_for(arch_id):
    """Each request's modality payload as ``Request`` keywords: source
    frames of 2-48 positions (encdec), patch embeddings on the even rids
    (vlm; the odd ones text-only), none otherwise."""
    arch = jax_get_arch(arch_id).reduced()
    if arch.family == "encdec":
        return [{"src_frames": f}
                for f in _frames(arch, N_REQ, MAX_LEN, SEED + 1)]
    if arch.family == "vlm":
        rng = np.random.RandomState(SEED + 3)
        return [{"patch_embeds": rng.standard_normal(
            (arch.frontend_tokens, arch.d_model)).astype(np.float32)}
            if i % 2 == 0 else {} for i in range(N_REQ)]
    return [{}] * N_REQ


@pytest.fixture
def jax_int8_shared_prefill(monkeypatch):
    """As in tests/test_torch_paging.py: lets the JAX paged engine run a
    shared-prefix prefill under int8 KV (its ``invalidate_padding`` gets
    the suffix's fp rows with the quantised cache's axes; ROADMAP C).
    Only ``pos`` is invalidated, so the axes are pruned to the rows'
    keys; nothing else changes."""
    from repro.serving import scheduler as JS
    orig = JS.invalidate_padding

    def prune(row, axes):
        if isinstance(row, dict):
            return {k: prune(v, axes[k]) for k, v in row.items()}
        return axes

    monkeypatch.setattr(JS, "invalidate_padding", lambda row, true_len, axes:
                        orig(row, true_len, prune(row, axes)))


_JAX_STREAMS = {}


def _jax_streams(path):
    if path not in _JAX_STREAMS:
        arch_id, int8, paged, mode = PATHS[path]
        arch_j = jax_get_arch(arch_id).reduced()
        params = jax.tree.map(jnp.asarray, _tree(arch_id))
        extra = {}
        if mode == "top_k":
            extra["sampling"] = JS.SamplingParams("top_k", TOP_K.temperature,
                                                  TOP_K.top_k)
        if mode == "spec":
            params = {"target": params,
                      "draft": jax.tree.map(jnp.asarray, _draft_tree())}
            extra["spec"] = JSpecConfig(draft=_draft_archs()[0], k=SPEC_K)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = JServingEngine(arch_j, params, dtype=jnp.float32,
                                 config=JServeConfig(
                                     slots=SLOTS, max_len=MAX_LEN,
                                     paging=JPagingConfig(paged=paged,
                                                          page_size=PS),
                                     quant=JQ.INT8_SERVE if int8
                                     else JQ.QuantConfig(), **extra))
        for i, (p, kw) in enumerate(zip(_prompts_for(arch_id),
                                        _payloads_for(arch_id))):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW, **kw))
        eng.run_until_drained(max_steps=2000)
        _JAX_STREAMS[path] = {r.rid: list(r.out_tokens) for r in eng.completed}
    return _JAX_STREAMS[path]


def _engine(path, lookahead=1):
    arch_id, int8, paged, mode = PATHS[path]
    arch = get_arch(arch_id).reduced()
    params = bridge.from_jax_params(_tree(arch_id), arch, device="cpu")
    extra = {}
    if mode == "top_k":
        extra["sampling"] = TOP_K
    if mode == "spec":
        draft = _draft_archs()[1]
        params = {"target": params,
                  "draft": bridge.from_jax_params(_draft_tree(), draft,
                                                  device="cpu")}
        extra["spec"] = SpecConfig(draft=draft, k=SPEC_K)
    return ServingEngine(arch, params, device="cpu", config=ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, lookahead=lookahead,
        paging=PagingConfig(paged=paged, page_size=PS),
        quant=Q.INT8_SERVE if int8 else Q.QuantConfig(), **extra))


def _addresses(eng) -> dict:
    out = {f"caches[{i}].{k}": v.data_ptr() for i, c in enumerate(eng.caches)
           for k, v in c.items()}
    for name, v in ST.tensors(eng.state).items():
        out[f"state.{name}"] = v.data_ptr()
    return out


def _margin(model, prompt, prefix, payload=None) -> float:
    """Top-2 logit margin, relative to the largest |logit|, of the port's
    model at the next position after ``prompt + prefix`` (with the
    request's source frames or patches, ``payload``)."""
    toks = torch.from_numpy(np.concatenate(
        [prompt, np.asarray(prefix, np.int32)]).astype(np.int32))[None]
    payload = payload or {}
    with torch.no_grad():
        if "src_frames" in payload:
            enc = model.encode(torch.from_numpy(payload["src_frames"])[None])
            hidden, _ = model(toks, enc)
        elif "patch_embeds" in payload:
            hidden, _ = model(toks, prefix_embeds=torch.from_numpy(
                payload["patch_embeds"])[None])
        else:
            hidden, _ = model(toks)
    logits = model.logits(hidden[:, -1]).float()[0]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]) / float(logits.abs().max())


def _diff(model, prompts, got, want, payloads=None):
    bad = []
    for rid in sorted(want):
        g, w = got.get(rid) or [], want[rid]
        if g == w:
            continue
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        payload = payloads[rid] if payloads else None
        bad.append(f"rid={rid}: port={g} jax={w} (first diff at {j}, top-2 "
                   f"margin {_margin(model, prompts[rid], w[:j], payload):.3e})")
    if set(got) != set(want):
        bad.append(f"completed sets differ: {sorted(got)} vs {sorted(want)}")
    return bad


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert not any(ops.launch_counts().values())  # CPU: plain versions


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("path", list(PATHS))
def test_caches_and_state_keep_their_addresses(path, lookahead,
                                               jax_int8_shared_prefill):
    eng = _engine(path, lookahead)
    assert eng.decode.graph is None  # the CPU runs the step eagerly
    caches, state = eng.caches, eng.state
    want = _addresses(eng)
    sched = eng.scheduler
    seen = {"steps": 0, "waves": 0}
    step = eng.step

    def checked_step():
        before = len(sched.prefill_dispatch_times)
        step()
        seen["steps"] += 1
        seen["waves"] += len(sched.prefill_dispatch_times) > before
        assert eng.caches is caches and eng.state is state
        moved = {k: v for k, v in _addresses(eng).items() if v != want[k]}
        assert not moved, f"step {seen['steps']}: moved {sorted(moved)}"

    eng.step = checked_step
    prompts = _prompts_for(PATHS[path][0])
    payloads = _payloads_for(PATHS[path][0])
    for i, (p, kw) in enumerate(zip(prompts, payloads)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW, **kw))
    eng.run_until_drained(max_steps=2000)
    assert seen["steps"] >= 8 and seen["waves"] >= 2, seen
    if PATHS[path][3] == "spec":
        assert any(k.startswith("state.draft_caches") for k in want)
    assert "state.rng" in want
    if eng.arch.family == "encdec":
        assert "state.enc_out" in want and "state.enc_len" in want
    got = {r.rid: list(r.out_tokens) for r in eng.completed}
    if PATHS[path][3] == "top_k":  # the margin of logits / T + gumbel
        from test_torch_sampling import stream_diff
        bad = stream_diff(eng.model, prompts, got, _jax_streams(path), TOP_K)
    else:
        bad = _diff(eng.model, prompts, got, _jax_streams(path), payloads)
    assert not bad, bad
    assert any(len(set(t)) > 2 for t in got.values()), got


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_step_equals_the_eager_step_on_a_clone(path):
    """Phase 4g's check on the CPU: after an admission, 16 steps of the
    engine's step and 16 of ``build_serve_step``'s eager step on a clone
    of caches and state give equal records and bit-equal leaves."""
    eng = _engine(path)
    prompts = _prompts_for(PATHS[path][0])
    payloads = _payloads_for(PATHS[path][0])
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                           **payloads[i]))
    eng.scheduler.admit(eng.model, eng.caches, eng.state)
    caches = [{k: v.clone() for k, v in c.items()} for c in eng.caches]
    state = ST.clone(eng.state)
    eager = REG.build_serve_step(eng.arch, sampling=eng.sampling,
                                 eos_id=eng.eos_id, paged=eng.paged,
                                 spec=eng.spec)
    for _ in range(16):
        state, caches, rec = eager(eng.params, caches, state)
        assert torch.equal(eng.decode(), CS.pack_record(rec))
    for i, (c, g) in enumerate(zip(caches, eng.caches)):
        for k in c:
            assert torch.equal(c[k], g[k]), f"caches[{i}].{k}"
    want = ST.tensors(eng.state)
    for k, v in ST.tensors(state).items():
        assert torch.equal(v, want[k]), f"state.{k}"


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_captured_launches_once_each():
    eng = _engine("fp")
    step = eng.decode

    def capture():  # what the wrappers count while a graph is captured
        ops.xfer_matmul.launches += 169
        ops.paged_attention.launches += 24

    ops.xfer_matmul.launches = 5  # counts made before the capture stay
    step.launches = CS.captured_launches(capture)
    assert step.launches == {"xfer_matmul": 169, "paged_attention": 24}
    assert ops.launch_counts()["xfer_matmul"] == 5
    assert ops.launch_counts()["paged_attention"] == 0
    step.graph, step.record = _FakeGraph(), torch.zeros((3, SLOTS), dtype=torch.int32)
    for n in range(1, 4):
        assert step() is step.record
        assert step.graph.replays == n
        counts = ops.launch_counts()
        assert counts["xfer_matmul"] == 5 + 169 * n
        assert counts["paged_attention"] == 24 * n
        assert sum(counts.values()) == 5 + 193 * n
    ops.reset_launches()


def test_held_workspace_survives_a_larger_scratch_request():
    dev = torch.device("cpu")
    name = "test_torch_step_graph"
    with _launch.hold_workspaces() as held:
        ws, cnt = _launch.scratch(name, dev, 100, 4)
        assert _launch.scratch(name, dev, 100, 4)[0] is ws  # reused, not grown
    assert len(held) == 1
    ptr, alive = ws.data_ptr(), weakref.ref(ws)
    del ws, cnt
    grown, _ = _launch.scratch(name, dev, 1 << 20, 4)
    gc.collect()
    assert grown.data_ptr() != ptr and alive() is not None
    assert [w.data_ptr() for w, _ in held.values()] == [ptr]
    assert not _launch._holders  # collection stopped with the block
    held.clear()
    gc.collect()
    assert alive() is None  # freed once no capture holds it
    del _launch._scratch[(name, None)]
