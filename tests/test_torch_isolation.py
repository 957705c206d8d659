"""``repro_torch`` stands alone: it imports neither ``jax`` nor the JAX
package, its launches run on the card unless the caller asks for the
CPU, and ``chip_smoke.py`` refuses to report a result without a card or
without the rest of the repository."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.core import cox

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)

CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None      # any import of jax now fails
    sys.modules["repro"] = None    # ... and of the JAX package
    import numpy as np
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    from repro_torch.core import cox

    @cox.kernel
    def scale(c, out: cox.Array(cox.f32), a: cox.Array(cox.f32), n: cox.i32):
        i = c.block_idx() * c.block_dim() + c.thread_idx()
        if i < n:
            out[i] = a[i] * 2.0

    print(scale.compiled(collapse="hier").summary())
    a = np.arange(40, dtype=np.float32)
    got = scale.launch(grid=2, block=32, args=(np.zeros(40, np.float32), a, 40),
                       device="cpu")["out"].numpy()
    assert (got == a * 2).all()
    print(len(names), "modules")
    """
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_imports_without_jax_or_the_jax_package(tmp_path):
    script = tmp_path / "child.py"  # file-backed: the frontend reads source
    script.write_text(CHILD)
    res = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, env=_env()
    )
    assert res.returncode == 0, res.stderr
    assert "kernel scale:" in res.stdout and "modules" in res.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_repro_imports_in_the_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


@cox.kernel
def _touch(c, out: cox.Array(cox.f32)):
    out[c.thread_idx()] = 1.0


def test_launch_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _touch.launch(grid=1, block=32, args=(torch.zeros(32),))


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        capture_output=True,
        text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
