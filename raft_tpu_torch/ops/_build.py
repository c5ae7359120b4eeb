"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Libraries land
in ``raft_tpu_torch/_build/`` (git-ignored; ``core.compile_cache.enable``
moves it before the first load) under a name carrying a
hash of the source and its headers, so an edited source rebuilds and a
stale library is never loaded. Nothing is built at import time: the
first launch of a kernel builds it, or :func:`build_all` builds every
kernel at once with one ``nvcc`` process per source, all running
together.

Each C entry point is an :class:`Entry`: the library is loaded, the
symbol resolved and its ``argtypes`` set once, at the first call; a
launch after that costs one attribute read.

Compiler: ``$NVCC`` if set, else ``nvcc`` on ``PATH``, else
``$CUDA_HOME/bin/nvcc`` (``CUDA_HOME`` defaulting to ``/usr/local/cuda``).
Target: ``sm_90a`` (Hopper), ``-O3``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

KERNEL_SOURCES = ("fused_l2_nn", "fused_l2_nn_tc", "select_k",
                  "ivf_flat_scan", "ivf_pq_scan", "ivf_bq_scan", "fused_knn",
                  "fused_knn_tc", "elementwise_dist")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# argument types of the entry points: every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits)
PTR, INT, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)


def nvcc_path() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = KERNEL_SOURCES,
              verbose: bool = False) -> Tuple[float, Dict[str, str]]:
    """Compile every kernel library not built yet, one ``nvcc`` per
    source, all started together. Returns ``(seconds, {name: ptxas
    report})``; raises ``RuntimeError`` with the compiler's output if
    any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _nvcc_cmd(name, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    from raft_tpu_torch.core.compile_cache import _note_event
    reports, errors = {}, []
    for name, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        reports[name] = text
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(rc={p.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
        # the builds run together: each one's seconds end where its
        # output is collected
        _note_event(False, time.perf_counter() - t0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0, reports


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            built = path.exists()
            if not built:
                build_all((name,))
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
            if built:
                from raft_tpu_torch.core.compile_cache import _note_event
                _note_event(True, time.perf_counter() - t0)
    return lib


def loaded() -> Tuple[str, ...]:
    """The names of the kernel libraries loaded so far, sorted."""
    with _lock:
        return tuple(sorted(_libs))


class Entry:
    """A C entry point ``symbol`` of the kernel library ``lib``, taking
    ``argtypes`` and returning a cudaError code. The library is built or
    loaded, and the function's ``argtypes`` set, once, at the first
    call."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence):
        self.lib, self.symbol = lib, symbol
        self.argtypes = list(argtypes)
        self._fn = None

    def __call__(self, *args) -> int:
        fn = self._fn
        if fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return fn(*args)


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError {rc}")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
