"""PyTorch/CUDA port of the ``repro`` serving system for NVIDIA Hopper.

A second package beside the JAX reference (``src/repro``). It imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and
never ``repro`` — and keeps its own copies of the framework-neutral
types it needs. Module names mirror the JAX package so each counterpart
is easy to find:

  configs/   ArchConfig / ShapeConfig, the qwen1.5-0.5b and
             recurrentgemma-2b configs
  kernels/   hand-written sm_90a CUDA kernels (csrc/), their ctypes
             wrappers, launch counters and plain PyTorch versions
  models/    the dense and hybrid (RG-LRU + local attention)
             decoder-only LM (layers, blocks, recurrent, lm, registry)
  serving/   ServeConfig, DecodeState, greedy sampler, scheduler, engine
  launch/    the serving CLI
  quant.py   INT8 serving: QTensor, quantize / quantize_kv,
             quantize_params, QuantConfig, INT8_SERVE
  bridge.py  JAX parameter tree (as numpy) -> port ``LM`` module
  device.py  device / dtype policy shared by every entry point

Entry points run on the card unless the caller passes ``device="cpu"``;
see :mod:`repro_torch.device`.
"""
