"""Build the CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface, `build/shrimp_tpu_torch/lib<name>.so` under the
repository root, and rebuilt whenever the source is newer than the
library.  Entry points take every pointer and the CUDA stream as
`c_void_p` and return `cudaGetLastError()`; `check_launch` turns a
nonzero code into an exception.  A failed build raises: there is no
fallback to the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "shrimp_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# one lock per kernel, so that different kernels build side by side
_name_locks: dict[str, threading.Lock] = {}
# per kernel: seconds the build took (0.0 when the library was current)
# and the compiler's report (registers, shared memory, spills)
BUILD_SECS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.sep, "usr", "local", "cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of shrimp_tpu_torch cannot be built")


def _compile(src: str, so: str) -> tuple[float, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (rc {r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, so)          # atomic: a concurrent loader sees old/new
    return time.time() - t0, r.stdout + r.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if os.path.exists(so) and \
                os.path.getmtime(so) >= os.path.getmtime(src):
            BUILD_SECS[name], BUILD_LOG[name] = 0.0, ""
        else:
            BUILD_SECS[name], BUILD_LOG[name] = _compile(src, so)
        lib = ctypes.CDLL(so)
        with _lock:
            _libs[name] = lib
        return lib


def load_all(names) -> dict[str, ctypes.CDLL]:
    """`load` several kernels at once: one nvcc process per source, all
    started together."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load, names)))


def check_launch(lib: ctypes.CDLL, kernel: str, rc: int) -> None:
    """Raise if a kernel entry point reported a CUDA error (every library
    exports `shrimp_error_string`, cudaGetErrorString)."""
    if rc != 0:
        fn = lib.shrimp_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch: "
                           f"{fn(rc).decode()}")


def require_cpu(*tensors) -> None:
    """The plain PyTorch versions take CPU tensors only: a tensor on a
    device goes to its kernel, never to the plain version."""
    for t in tensors:
        if t is not None and t.device.type != "cpu":
            raise ValueError("the plain PyTorch version takes CPU tensors "
                             f"only; got a tensor on {t.device}")


def check_tensor(name: str, t, dtype, ndim: int, device) -> None:
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype`,
    `ndim`-dimensional and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class LaunchCounter:
    """Number of kernel launches a wrapper made (thread-safe)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n
