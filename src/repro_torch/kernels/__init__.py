"""Hand-written Hopper (sm_90a) kernels of the port and their wrappers.

``csrc/*.cu`` are the CUDA sources, ``build.py`` compiles them with
``nvcc`` at first use, ``xfer_matmul.py`` / ``quant_matmul.py`` /
``flash_attention.py`` / ``paged_attention.py`` (fp and int8 bodies) /
``rglru_scan.py`` / ``mlstm_chunkwise.py`` are the wrappers (input
checks, launch, launch counter, plain version), ``ref.py`` holds the
plain versions and ``ops.py`` the public entry points.
"""
