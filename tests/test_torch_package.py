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
        "import singa_tpu_torch.ops._build, singa_tpu_torch.ops.softmax_xent\n"
        "import singa_tpu_torch.opt, singa_tpu_torch.loss\n"
        "import singa_tpu_torch.metric\n"
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


def test_every_kernel_has_its_source():
    from singa_tpu_torch.ops import _build

    assert set(_build.KERNELS) == {"flash_attn_fwd", "flash_attn_bwd",
                                   "softmax_xent"}
    for name in _build.KERNELS:
        src = _build.CSRC / f"{name}.cu"
        assert src.is_file(), src
        text = src.read_text()
        assert "Replaces: singa_tpu/ops/pallas_kernels.py" in text
        assert "singa_cuda_error_string" in text
        assert "cudaGetLastError()" in text


def _wrappers():
    from singa_tpu_torch.ops import flash_attention, softmax_xent

    return [(flash_attention.flash_attention, "launches"),
            (flash_attention.flash_attention_bwd, "dq_launches"),
            (flash_attention.flash_attention_bwd, "dkv_launches"),
            (softmax_xent.softmax_xent, "launches"),
            (softmax_xent.softmax_xent_bwd, "launches")]


@pytest.mark.parametrize("index", range(5))
def test_every_kernel_wrapper_counts_its_launches(index):
    fn, attr = _wrappers()[index]
    assert isinstance(getattr(fn, attr), int), (fn.__name__, attr)


def _c_params(source: str, fn: str):
    """The parameter kinds of `int fn(...)` in a kernel source: "ptr",
    "int" or "float"."""
    import re

    sig = re.search(rf"int {fn}\(([^)]*)\)", source).group(1)
    return [p.split()[-2] if "*" not in p else "ptr"
            for p in (" ".join(x.split()) for x in sig.split(","))]


@pytest.mark.parametrize("source,fn,module", [
    ("softmax_xent", "singa_softmax_xent_fwd", "softmax_xent"),
    ("softmax_xent", "singa_softmax_xent_bwd", "softmax_xent"),
    ("flash_attn_bwd", "singa_flash_attn_bwd_dq", "flash_attention"),
    ("flash_attn_bwd", "singa_flash_attn_bwd_dkv", "flash_attention"),
])
def test_c_interfaces_match_the_wrappers_argtypes(source, fn, module,
                                                  monkeypatch):
    """The argtypes each wrapper sets follow the C signature of its kernel
    source (ctypes would pass a pointer given as an int as 32 bits)."""
    import ctypes
    import importlib
    from types import SimpleNamespace

    from singa_tpu_torch.ops import _build

    kinds = _c_params((_build.CSRC / f"{source}.cu").read_text(), fn)
    lib = SimpleNamespace(**{
        name: SimpleNamespace(argtypes=None)
        for name in ("singa_softmax_xent_fwd", "singa_softmax_xent_bwd",
                     "singa_flash_attn_bwd_dq", "singa_flash_attn_bwd_dkv")})
    monkeypatch.setattr(_build, "load", lambda name: lib)
    mod = importlib.import_module(f"singa_tpu_torch.ops.{module}")
    (mod._lib if module == "softmax_xent" else mod._bwd_lib)()
    names = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    assert [names[t] for t in getattr(lib, fn).argtypes] == kinds
