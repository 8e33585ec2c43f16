"""Device and dtype policy for every entry point of the port.

``device=None`` means ``"cuda"``. Without a CUDA device that raises: the
port never falls back to the CPU on its own, because a CPU run says
nothing about the card. Tests and parity checks ask for the CPU
explicitly with ``device="cpu"``.

The dtype follows the JAX package's serving policy (``repro.api``
``Executable``): bf16 params and caches on an accelerator, fp32 on the
CPU. Both are overridable by argument.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port on the CPU (plain PyTorch versions of the kernels)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def default_dtype(device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """bf16 on CUDA, fp32 on the CPU, unless ``dtype`` is given."""
    if dtype is not None:
        return dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32
