"""Build the port's CUDA kernels from `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/singa_tpu_torch/lib<name>-<hash>.so` at the
root of the checkout; an installed copy of the package (no `pyproject.toml`
two levels above it) builds into `$XDG_CACHE_HOME/singa_tpu_torch`, else
`~/.cache/singa_tpu_torch`, instead of beside site-packages. The hash covers the source and the flags, so an edit
rebuilds and an unchanged source loads the library already built. Nothing is
built when a module is imported: the first call of a kernel's wrapper builds
it, or `build_all()` builds every kernel up front, one `nvcc` per source, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir(module_file: str = __file__) -> Path:
    root = Path(module_file).resolve().parents[2]
    if (root / "pyproject.toml").is_file():  # a source checkout
        return root / "build" / "singa_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "singa_tpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "softmax_xent")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """The CUDA toolkit's compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on
    PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from source on first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> List[Path]:
    """Build every named kernel that is not built yet, one `nvcc` process
    per source, all running at once. Returns the library paths. The
    compiler's output (ptxas register and shared-memory use) is kept beside
    each library as `<lib>.log`."""
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, path in todo:
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        log = open(path.with_suffix(".so.log"), "w", encoding="utf-8")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, path, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}, log {log.name})")
            continue
        os.replace(tmp, path)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))
    return paths


def build_log(name: str) -> str:
    p = library_path(name).with_suffix(".so.log")
    return p.read_text(encoding="utf-8") if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use and loaded once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            (path,) = build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.singa_cuda_error_string.argtypes = [ctypes.c_int]
            lib.singa_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        msg = lib.singa_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
