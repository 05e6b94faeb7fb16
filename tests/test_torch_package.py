"""Package rules of the PyTorch port: it imports neither `jax` nor the JAX
package, it runs on CUDA unless the CPU is asked for, and its smoke script
refuses to run without a card or without the port beside it."""
import ast
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import singa_tpu_torch
from singa_tpu_torch import device
from singa_tpu_torch.models.transformer import TransformerLM

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "singa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "singa_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import singa_tpu_torch, singa_tpu_torch.ops.flash_attention\n"
        "import singa_tpu_torch.ops._build\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_get_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.get_device()
    with pytest.raises(RuntimeError):
        device.get_device("cuda:0")
    with pytest.raises(RuntimeError):
        TransformerLM(11, d_model=8, num_heads=2, num_layers=1, max_len=4)
    assert device.get_device("cpu") == torch.device("cpu")


def test_generator_is_seeded():
    a = torch.rand(4, generator=device.generator(7))
    b = torch.rand(4, generator=device.generator(7))
    assert torch.equal(a, b)


def test_fp32_matmul_precision_is_pinned():
    from singa_tpu_torch import tensor

    assert tensor.get_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    try:
        tensor.set_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(ValueError):
            tensor.set_matmul_precision("fast")
    finally:
        tensor.set_matmul_precision("highest")
    assert torch.backends.cudnn.allow_tf32 is False


def test_compute_dtype_casts_matmul_operands():
    from singa_tpu_torch import autograd, tensor

    a, b = torch.randn(3, 4), torch.randn(4, 2)
    try:
        tensor.set_compute_dtype("bfloat16")
        assert autograd.matmul(a, b).dtype == torch.bfloat16
    finally:
        tensor.set_compute_dtype(None)
    assert autograd.matmul(a, b).dtype == torch.float32


def test_kernel_sources_ship_as_package_data():
    text = (ROOT / "pyproject.toml").read_text()
    assert "ops/csrc/*.cu" in text
    assert list((PORT / "ops" / "csrc").glob("*.cu"))


def _load_smoke(path: Path):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _load_smoke(ROOT / "chip_smoke.py").main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_fails_without_the_port_beside_it(tmp_path, monkeypatch,
                                                     capsys):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert Path(singa_tpu_torch.__file__).resolve().parents[1] == ROOT
    assert _load_smoke(lone).main() != 0
    assert '"ok"' not in capsys.readouterr().out
