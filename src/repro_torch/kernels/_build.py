"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. The
libraries go to ``build/repro_torch/<hash>/`` at the repo root, keyed by a
hash of the sources and flags, and are built at first use (all sources in
parallel, one ``nvcc`` each). A missing ``nvcc``, a failed build or a
failed launch raises; nothing falls back to a plain version.

Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per-source extra flags: the match kernel's float32 score must not be
# contracted into FMAs (it also spells out __fmul_rn/__fadd_rn)
EXTRA_FLAGS: Dict[str, Sequence[str]] = {"match.cu": ("--fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels build "
                       "only where the CUDA toolkit is installed")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(repr((NVCC_FLAGS, sorted(EXTRA_FLAGS.items()))).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; returns name -> library."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.name: out_dir / (src.stem + ".so") for src in _sources()}
    todo = [src for src in _sources() if not libs[src.name].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = out_dir / f"{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(src.name, ()),
               "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
        else:
            os.replace(tmp, libs[src.name])
    if failures:
        raise RuntimeError("repro_torch: nvcc failed\n" + "\n".join(failures))
    return libs


def _library(source: str) -> ctypes.CDLL:
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build_all()[source]))
    return _loaded[source]


class Kernel:
    """One C launch function of one ``csrc`` source, with a launch count.

    ``launches`` rises by one per successful launch and nowhere else;
    ``chip_smoke.py`` zeroes it before the main path and reads it after.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"repro_torch: {self.name} launch failed "
                               f"(cudaError {err})")
        self.launches += 1


def c_helper(source: str, symbol: str, argtypes, restype):
    """A C function of one ``csrc`` source that launches nothing (a size
    query): it is bound on first use and has no launch count."""
    fn = getattr(_library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """Wrapper-side checks before a pointer goes to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
