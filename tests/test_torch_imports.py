"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
JAX nor the JAX package, and an entry point left on its default device
(codec, memory mode, the paged store, the model and its caches, the
training driver and protected checkpoints) raises
when there is no CUDA device instead of running on the CPU."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import torch_threads_per_worker  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, f


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch.core import (PIMConfig, ProtectionConfig,
                                  decode_integers, get_code,
                                  protected_pim_matmul)
    from repro_torch.device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.memory import (MemoryController, PagedProtectedStore,
                                    ProtectedMemoryArray, RepairQueue)
    from repro_torch.models import (ProtectedKVConfig, ProtectedKVLayer,
                                    init_caches, init_params)
    from repro_torch import checkpoint
    from repro_torch.launch.train import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = get_code("wl40_r08")
    y = np.zeros((2, code.n), np.int64)
    cfg = get_config("paper_pim").reduced(n_groups=1, d_model=16,
                                          n_heads=2, d_ff=32, vocab=32)
    pkv = ProtectedKVConfig(code_name="wl40_r08", page_tokens=4)
    for call in (
            lambda: PagedProtectedStore("wl40_r08"),
            lambda: ProtectedKVLayer(pkv, 1, 2, 8),
            lambda: init_params(cfg),
            lambda: init_caches(cfg, 1, 8),
            lambda: init_caches(cfg, 1, 8, protected_kv=pkv),
            lambda: run(cfg, steps=1, batch=1, seq=4),
            lambda: checkpoint.save_checkpoint(
                str(tmp_path), 1, {"w": np.zeros(2)}, protect=True),
            lambda: resolve_device(),
            lambda: ProtectedMemoryArray("wl40_r08"),
            lambda: MemoryController(),
            lambda: RepairQueue(code),
            lambda: decode_integers(code, y),
            lambda: protected_pim_matmul(
                np.zeros((2, 4), np.int64), np.zeros((4, code.n), np.int64),
                code, ProtectionConfig(), PIMConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, or handed CPU tensors, they run there
    assert ProtectedMemoryArray("wl40_r08", device="cpu").device.type == "cpu"
    assert init_params(cfg, device="cpu").device.type == "cpu"
    assert PagedProtectedStore("wl40_r08", device="cpu").device.type == "cpu"
    y_corr, _ = decode_integers(code, torch.as_tensor(y), n_iters=2)
    assert y_corr.device.type == "cpu"


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    env = _env(CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    run = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout
