"""The port's examples (`scripts/*_torch.py`, the counterparts of
`examples/*.py`) run to their end on the CPU (`--cpu`), each in this
process as `python scripts/<name>_torch.py --cpu` would run it;
`train_small` at a size the test passes in and two steps. Without
`--cpu` they run on the card, and raise where there is none; they import
neither JAX nor the JAX package."""
import ast
import runpy
import sys
from pathlib import Path

import pytest
import torch

from _torch_threads import torch_threads_per_worker  # noqa: F401

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
NAMES = ("quickstart", "memory_mode", "serve_protected", "train_small")


def _run(monkeypatch, name, *args):
    path = SCRIPTS / f"{name}_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), *args])
    runpy.run_path(str(path), run_name="__main__")


@pytest.mark.parametrize("name,last", [
    ("quickstart", "OK: NB-LDPC corrected the PIM MAC"),
    ("memory_mode", "OK: memory-mode NB-LDPC recovered the corrupted "
                    "checkpoint."),
])
def test_library_examples_run_on_cpu(monkeypatch, capsys, name, last):
    _run(monkeypatch, name, "--cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(last)


def test_serve_protected_example_runs_on_cpu(monkeypatch, capsys):
    _run(monkeypatch, "serve_protected", "--cpu")
    out = capsys.readouterr().out
    assert out.count("generated tokens:") == 2
    assert out.count("[NB-LDPC protected]") == 2


def test_train_small_example_runs_on_cpu(monkeypatch, capsys, tmp_path):
    _run(monkeypatch, "train_small", "--cpu", "--steps", "2",
         "--d-model", "64", "--n-groups", "2", "--vocab", "256",
         "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path))
    out = capsys.readouterr().out
    assert "step     1" in out and "final loss" in out


@pytest.mark.parametrize("name", NAMES)
def test_examples_need_the_card_without_cpu(monkeypatch, tmp_path, name):
    path = SCRIPTS / f"{name}_torch.py"
    tree = ast.parse(path.read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(monkeypatch, name, "--steps", "1", "--ckpt-dir", str(tmp_path))
