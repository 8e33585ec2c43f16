"""The decode step as one captured program: the port's counterpart of the
reference's jitted serve step with donated caches and state
(``repro/serving/engine.py``, ``mesh_jit(..., donate_argnums=(1, 2))``).

:class:`CapturedStep` binds the in-place serve step of
``models.registry.build_serve_step`` to one engine's model, caches and
:class:`~repro_torch.serving.state.DecodeState`. The step's shapes are
fixed for the engine's life (slots, ``max_len``, the page table's
width), and the step writes its caches and state in place, so every
leaf keeps its address. On CUDA tensors the step is captured once, as
one CUDA graph, when the :class:`CapturedStep` is built, and every call
replays it; the hand-written kernels launch inside the graph. On CPU
tensors every call runs the same in-place step eagerly through the
kernels' plain versions. There is no eager fallback on CUDA: a capture
that fails raises.

The capture runs one real step first, on a side stream, so that every
kernel library is loaded, every launch plan and workspace exists and
PyTorch's own lazy state is set up before capture begins. That step
writes the caches and state like any step, so it is taken where that is
harmless: on the all-inactive state at engine construction, where every
slot is inert and its rows are overwritten whole when a request is
admitted (an inert dense slot writes position 0 of its row, a paged one
the null page).

Two things outlive the capture on the graph's behalf:

- the kernels' workspaces (``kernels._launch.scratch``): a later, larger
  request (a prefill on the split-K route) replaces the buffers in the
  cache, and the graph keeps the ones whose addresses it recorded;
- the launch counts: the wrappers count Python calls, so the capture's
  own count is taken back off the counters and added again on every
  replay, as if each replay had called the wrappers.

Each call returns the step's per-slot record packed as ``[2c + 1, slots]``
int32 (c rows of tokens, c of emit flags, then finished; c = 1 for the
plain step, k + 1 for the speculative one). On CUDA it is the graph's
static output,
overwritten by the next replay: read it, or copy it, on the same stream
before that replay (the engine enqueues its device-to-host copy right
after the replay).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels import ops
from repro_torch.serving.state import DecodeState


def pack_record(record: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``{token, emit, finished}`` -> ``[2c + 1, slots]`` int32: token and
    emit are ``[slots]`` (c = 1) or ``[slots, c]`` (the speculative step's
    c = k + 1 sub-steps), finished ``[slots]``."""
    token, emit = record["token"], record["emit"]
    if token.dim() == 1:
        token, emit = token[:, None], emit[:, None]
    return torch.cat([token.T.to(torch.int32), emit.T.to(torch.int32),
                      record["finished"].to(torch.int32)[None]])


def unpack_record(packed):
    """``pack_record``'s inverse on a host array ``[2c + 1, slots]``:
    (token ``[slots, c]``, emit ``[slots, c]``, finished ``[slots]``)."""
    c = (packed.shape[0] - 1) // 2
    return packed[:c].T, packed[c:2 * c].T, packed[2 * c]


def captured_launches(capture: Callable[[], object]) -> Dict[str, int]:
    """Run ``capture`` (the capture of a graph: the wrappers are called,
    nothing launches) and return the launches it counted per kernel,
    taken back off the counters."""
    before = ops.launch_counts()
    capture()
    counts = {name: n - before[name]
              for name, n in ops.launch_counts().items() if n != before[name]}
    ops.add_launches({name: -n for name, n in counts.items()})
    return counts


class CapturedStep:
    """``CapturedStep(step, model, caches, state)``; ``step()`` advances
    every slot by one decode step in place and returns the packed record.

    ``step`` is the stateful ``serve_step`` of
    ``registry.build_serve_step`` (plain or speculative; ``model`` is then
    the ``{"target", "draft"}`` pair). On CUDA the graph is captured here:
    :attr:`graph` is the ``torch.cuda.CUDAGraph``, :attr:`launches` the
    kernel launches of one replay, :attr:`workspaces` the kernel
    workspaces it holds. On the CPU :attr:`graph` is None."""

    def __init__(self, step: Callable, model, caches: List[dict],
                 state: DecodeState):
        self.step, self.model = step, model
        self.caches, self.state = caches, state
        self.device = state.tokens.device
        self.graph = None
        self.record = None
        self.launches: Dict[str, int] = {}
        self.workspaces: dict = {}
        if self.device.type == "cuda":
            self._capture()

    def _run(self) -> torch.Tensor:
        state, caches, record = self.step(self.model, self.caches, self.state)
        if state is not self.state or caches is not self.caches:
            raise RuntimeError("the serve step did not update its caches and "
                               "state in place")
        return pack_record(record)

    def _capture(self) -> None:
        dev = self.device
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        with _launch.hold_workspaces() as held, torch.cuda.device(dev):
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._run()  # warm-up: a real step on the inert slots

            def capture():
                with torch.cuda.graph(graph, stream=stream):
                    self.record = self._run()

            self.launches = captured_launches(capture)
            torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph, self.workspaces = graph, held

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            return self._run()
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.record
