"""Public kernel entry points of the port (mirrors ``repro/kernels/ops.py``).

The JAX package dispatches Pallas on the TPU and interpret mode
elsewhere; here each wrapper launches its CUDA kernel for CUDA tensors
and takes its plain PyTorch version for CPU tensors — the choice follows
the tensors' device and nothing else.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_lse,
    flash_attention_q8, prefix_attention)
from repro_torch.kernels.mlstm_chunkwise import (mlstm_chunkwise,
                                                 mlstm_chunkwise_fold)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_q8,
                                                 paged_attention_q8_multi)
from repro_torch.kernels.quant_matmul import (quant_matmul,
                                               quant_matmul_experts)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.xfer_matmul import xfer_matmul, xfer_matmul_experts

#: every kernel wrapper of the port; each carries a ``launches`` counter
#: (``paged_attention_q8`` and ``flash_attention_q8`` are the int8 bodies
#: behind ``paged_attention``'s and ``flash_attention``'s
#: ``k_scale``/``v_scale``; ``prefix_attention`` counts under
#: ``flash_attention`` with an fp prefix and under ``flash_attention_q8``
#: with an int8 one; ``mlstm_chunkwise`` also counts the launches of
#: ``mlstm_chunkwise_fold``, its entry with a state;
#: ``xfer_matmul_experts`` is ``xfer_matmul``'s expert axis, the MoE
#: layer's expert products in one launch, counted on its own, and
#: ``quant_matmul_experts`` ``quant_matmul``'s, the same under INT8
#: weights; ``paged_attention_q8_multi`` is the int8 body's multi-query
#: form, the speculative verify over an int8 grid or pool;
#: ``flash_attention_bwd`` is the fp forms' gradient (causal or not, S
#: queries over T keys), the training step's backward, one count a launch
#: of its three kernels; the training forward (``flash_attention_lse``)
#: counts under ``flash_attention``, ``xfer_matmul``'s backward products
#: under ``xfer_matmul`` and ``xfer_matmul_experts``' (dgrad, wgrad)
#: under ``xfer_matmul_experts``)
KERNELS = (xfer_matmul, flash_attention, flash_attention_q8, paged_attention,
           paged_attention_q8, quant_matmul, rglru_scan, mlstm_chunkwise,
           xfer_matmul_experts, quant_matmul_experts,
           paged_attention_q8_multi, flash_attention_bwd)


# the JAX package's ``ops`` names
matmul = xfer_matmul
expert_matmul = xfer_matmul_experts
int8_matmul = quant_matmul
int8_expert_matmul = quant_matmul_experts
attention = flash_attention
paged_attn = paged_attention
lru_scan = rglru_scan
mlstm = mlstm_chunkwise
#: the kernel's own entry: log-forget gates, an initial state, the final
#: state out (the mLSTM prefill of ``models/recurrent.py``)
mlstm_fold = mlstm_chunkwise_fold


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches) to the wrappers' counters:
    a CUDA graph's replay launches what its capture recorded, without a
    Python call of the wrappers."""
    for k in KERNELS:
        k.launches += counts.get(k.__name__, 0)


# plain versions re-exported for tests and chip_smoke.py
matmul_ref = ref.matmul_ref
expert_matmul_ref = ref.expert_matmul_ref
expert_matmul_dgrad_ref = ref.expert_matmul_dgrad_ref
expert_matmul_wgrad_ref = ref.expert_matmul_wgrad_ref
int8_matmul_ref = ref.quant_matmul_ref
int8_expert_matmul_ref = ref.quant_matmul_experts_ref
attention_ref = ref.flash_attention_ref
attention_lse_ref = ref.flash_attention_lse_ref
attention_bwd_ref = ref.flash_attention_bwd_ref
prefix_attention_ref = ref.prefix_attention_ref
paged_attn_ref = ref.paged_attention_ref
paged_attn_split_ref = ref.paged_attention_split_ref
lru_scan_ref = ref.rglru_scan_ref
mlstm_ref = ref.mlstm_ref
mlstm_fold_ref = ref.mlstm_chunkwise_ref
