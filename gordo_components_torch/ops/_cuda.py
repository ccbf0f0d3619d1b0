"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, and loaded with
``ctypes``. Libraries land in ``build/torch_kernels/`` beside the package
(named by a hash of the source and flags, so an edited source rebuilds) and
are reused while they exist. All sources build in parallel: one ``nvcc``
per source, all started together.

Nothing here runs at import time, and a build failure raises: there is no
fallback to the plain PyTorch versions for tensors on the card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (on PATH or under $CUDA_HOME/bin): the port's CUDA "
        "kernels are compiled at first use and need the CUDA toolkit"
    )


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no library yet, one ``nvcc`` per source, all running at once. Returns
    name -> library path; raises with the compiler's output on failure."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if names is not None:
        srcs = [s for s in srcs if s.stem in names]
        missing = set(names) - {s.stem for s in srcs}
        if missing:
            raise FileNotFoundError(f"no CUDA source for {sorted(missing)} in {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s.stem: _lib_path(s) for s in srcs}
    todo = [(s, out[s.stem]) for s in srcs if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for src, lib in todo:
        # a private temp name, renamed into place when complete, so a
        # concurrent process never loads a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
        return lib


class LaunchCounts(dict):
    """wrapper name -> kernel launches since the last :meth:`reset`; each
    wrapper calls :meth:`add` where it launches its kernel, and only there,
    so a run can show that its main path went through the kernels."""

    def __init__(self, *names: str):
        super().__init__({n: 0 for n in names})
        self._lock = threading.Lock()

    def add(self, name: str) -> None:
        with self._lock:
            self[name] += 1

    def reset(self) -> None:
        with self._lock:
            for k in self:
                self[k] = 0


def check_tensor(name: str, t, dtype, shape: Sequence[int], device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's plain C interface takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
