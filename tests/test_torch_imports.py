"""Import guard for the PyTorch port.

``src/repro_torch/`` and ``chip_smoke.py`` must never import JAX or the JAX
package (the machine with the card has no JAX), importing the port must build
nothing (no ``nvcc`` here), and the entry points must raise rather than fall
back to the CPU when no CUDA device is present.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "repro"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_found():
    assert len(FILES) > 20
    assert (PORT / "kernels" / "csrc" / "splitzip_encode.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "splitzip_decode.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "splitzip_attention.cu").is_file()
    assert (PORT / "kernels" / "csrc" / "flash_attention.cu").is_file()
    for module in ("kernels/flash_attention.py", "models/moe.py"):
        assert PORT / module in FILES, module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path}: imports {bad}"


def test_guard_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import codec\n"
                 "from repro_torch.core import codec\nimport repro\n")
    assert [m for _, m in _imports(f) if _forbidden(m)] == [
        "jax.numpy", "repro.core", "repro"]


def test_importing_the_port_builds_nothing():
    """Every module imports in a fresh interpreter without starting a
    process or loading a kernel library."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, subprocess, sys
        sys.path.insert(0, {str(REPO / "src")!r})
        def refuse(*a, **k):
            raise AssertionError("a subprocess was started while importing")
        subprocess.Popen = refuse
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                        "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        from repro_torch.kernels import build
        assert build.loaded() == {{}}, build.loaded()
        assert "jax" not in sys.modules and "repro" not in sys.modules
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.base import get_config
    from repro_torch.core.codebook import DEFAULT_BF16_CODEBOOK
    from repro_torch.device import default_device, resolve_device
    from repro_torch.launch import serve
    from repro_torch.serving.engine import DisaggregatedEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedEngine(cfg, {}, DEFAULT_BF16_CODEBOOK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m", "--reduced"])


def test_other_families_not_yet_ported():
    from repro_torch.configs.base import get_config
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("mamba2-2.7b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    for arch in ("smollm-135m", "llama3.2-3b", "qwen3-32b", "minicpm3-4b"):
        assert get_config(arch).family == "dense"
    assert get_config("minicpm3-4b").mla is not None
    moe = get_config("qwen3-moe-30b-a3b")
    assert moe.family == "moe" and moe.moe is not None


def test_importing_attention_kernels_builds_nothing():
    """The paged-attention wrappers build their library at the first launch
    on a card, never at import, and never for CPU operands."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO / "src")!r})
        from repro_torch.kernels import build, splitzip_attention as SA
        from repro_torch.kernels import attention_cases as AC
        case = AC.gqa_case("bf16", 0, batch=1, nq=1, heads=2, hkv=1, hd=64,
                           dv=64, tp=16, pages=2, lens=[32])
        SA.paged_gqa_attention(**case)
        assert build.loaded() == {{}}, build.loaded()
        assert SA.paged_gqa_attention.launches == 0
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
