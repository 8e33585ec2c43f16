"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

* importing every ``repro_torch`` module (in a fresh interpreter) loads
  no ``jax*`` and no ``repro``/``repro.*`` module;
* ``chip_smoke.py`` imports neither (parsed, not run);
* without a CUDA device the entry points raise unless given
  ``device="cpu"``, and ``chip_smoke.py`` exits non-zero with no result
  line, also from a directory that holds nothing else of the repo.
"""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
print(len(names), "modules:", sorted(names), "leaked:", bad)
assert not bad, bad
"""


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only policy does not apply")


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "leaked: []" in out.stdout
    for name in ("repro_torch.quant", "repro_torch.kernels.quant_matmul",
                 "repro_torch.kernels.paged_attention",
                 "repro_torch.kernels.rglru_scan", "repro_torch.models.recurrent",
                 "repro_torch.configs.recurrentgemma_2b",
                 "repro_torch.kernels.mlstm_chunkwise",
                 "repro_torch.configs.xlstm_350m"):
        assert f"'{name}'" in out.stdout, name


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_no_repro():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.registry import init_params
    from repro_torch.quant import INT8_SERVE
    from repro_torch.serving import ServeConfig, ServingEngine
    arch = get_arch("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_params(arch)
    model = init_params(arch, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(arch, model, config=ServeConfig(slots=2, max_len=16))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(arch, model, config=ServeConfig(slots=2, max_len=16,
                                                      quant=INT8_SERVE))
    assert not model.weights_quantized  # nothing happened to the model
    tree = {"embed": np.zeros((arch.vocab_size, arch.d_model), np.float32)}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bridge.from_jax_params(tree, arch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--requests", "1"])


def test_serve_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    engine = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                         "--max-len", "32", "--new-tokens", "3"])
    assert len(engine.completed) == 3
    assert all(len(r.out_tokens) == 3 for r in engine.completed)
    assert "3/3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--temperature", "0.7"], ["--top-k", "5"]])
def test_serve_cli_sampling_flags_raise_until_ported(flags):
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="greedy only"):
        serve.main(["--device", "cpu", "--requests", "1", *flags])


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    _no_cuda()
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:  # a directory with chip_smoke.py and nothing else of the repo
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
