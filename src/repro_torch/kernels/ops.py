"""Public kernel entry points of the port (mirrors ``repro/kernels/ops.py``).

The JAX package dispatches Pallas on the TPU and interpret mode
elsewhere; here each wrapper launches its CUDA kernel for CUDA tensors
and takes its plain PyTorch version for CPU tensors — the choice follows
the tensors' device and nothing else.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mlstm_chunkwise import (mlstm_chunkwise,
                                                 mlstm_chunkwise_fold)
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_q8)
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.xfer_matmul import xfer_matmul

#: every kernel wrapper of the port; each carries a ``launches`` counter
#: (``paged_attention_q8`` is the int8 body behind ``paged_attention``'s
#: ``k_scale``/``v_scale``; ``mlstm_chunkwise`` also counts the launches
#: of ``mlstm_chunkwise_fold``, its entry with a state)
KERNELS = (xfer_matmul, flash_attention, paged_attention, paged_attention_q8,
           quant_matmul, rglru_scan, mlstm_chunkwise)


# the JAX package's ``ops`` names
matmul = xfer_matmul
int8_matmul = quant_matmul
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


# plain versions re-exported for tests and chip_smoke.py
matmul_ref = ref.matmul_ref
int8_matmul_ref = ref.quant_matmul_ref
attention_ref = ref.flash_attention_ref
paged_attn_ref = ref.paged_attention_ref
lru_scan_ref = ref.rglru_scan_ref
mlstm_ref = ref.mlstm_ref
mlstm_fold_ref = ref.mlstm_chunkwise_ref
