"""Build the port's CUDA C++ kernels at first use and bind them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
`_build_cache/`.  The library's file name carries a hash of the source and
the flags: an edited source rebuilds, an unchanged one loads from the cache.
Nothing here runs at import time; a machine without nvcc can import the
package and use the kernels' plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
CACHE = _HERE / "_build_cache"
# --fmad=false: no multiply-add contraction, so every kernel rounds each
# operation exactly as its plain PyTorch version does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


_EXTRA: dict[str, tuple] = {}     # name -> extra nvcc flags (see `variant`)


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + _EXTRA.get(name, ())


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return src, CACHE / f"{name}-{key}.so"


def _start_build(name: str):
    """Start nvcc on `csrc/<name>.cu` unless its library is cached.
    -> (process, temporary output, final library, source) or None."""
    src, so = _paths(name)
    if so.exists():
        return None
    CACHE.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *_flags(name), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, src


def _finish_build(started) -> None:
    proc, tmp, so, src = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    so.with_suffix(".log").write_text(out)
    os.replace(tmp, so)      # a concurrent process never sees a partial file


def build_all() -> None:
    """Build every kernel source of `csrc/` whose library is not cached,
    one nvcc per source, all started together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        started = [b for b in map(_start_build, names) if b is not None]
        errors = []
        for b in started:
            try:
                _finish_build(b)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its cached library is missing, then load
    it (once per process)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(started)
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
        return lib


@contextlib.contextmanager
def variant(name: str, *flags: str):
    """Within the block `load(name)` gives a build of `csrc/<name>.cu` with
    extra nvcc flags (a -D switch of the source, such as a profiling
    mode); afterwards the regular build is back."""
    with _LOCK:
        regular = _LIBS.pop(name, None)
        _EXTRA[name] = tuple(flags)
    try:
        yield
    finally:
        with _LOCK:
            _EXTRA.pop(name, None)
            _LIBS.pop(name, None)
            if regular is not None:
                _LIBS[name] = regular


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    cached build of `csrc/<name>.cu`; empty if it is not built."""
    log = _paths(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""

