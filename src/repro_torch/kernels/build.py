"""Build-and-load for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entries and is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use,
then loaded with ``ctypes``.  Libraries go to ``src/repro_torch/_build/``
(ignored by git), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one loads the existing library.  ``build_many`` starts
one ``nvcc`` per missing library, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# every library of the port, in the order chip_smoke.py reports them
KERNELS = ("cascade_tiered", "cascade_flat", "linkload", "flash_attention",
           "flash_attention_sm90")

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# what this process built: libraries compiled with nvcc and libraries
# loaded (once each); netsim.sweep.cache_stats reports their sum as builds
STATS = {"compiled": 0, "loaded": 0}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use "
                       "and need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_many(names) -> list[pathlib.Path]:
    """Compile each ``csrc/<name>.cu`` whose hashed library is missing, one
    ``nvcc`` per source, all started together; returns the library paths."""
    outs = [library_path(n) for n in names]
    todo = [(n, out) for n, out in zip(names, outs) if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    try:
        for name, out in todo:
            # build to a temporary name in the same directory, then rename:
            # a concurrent or interrupted build never leaves a truncated library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n{err}")
            else:
                os.replace(tmp, out)
                STATS["compiled"] += 1
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return outs


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    return build_many([name])[0]


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    STATS["loaded"] += 1
    return ctypes.CDLL(path)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    with _LOCK:
        return _load(str(build(name)))


@functools.lru_cache(maxsize=None)
def entry(name: str, fn: str, argtypes: tuple):
    """The C entry ``fn`` of ``csrc/<name>.cu``, built and loaded once per
    process, returning a CUDA error code.  ``argtypes`` are ctypes types:
    ``c_void_p`` for each pointer and the stream, so none is cut to 32 bits."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper checks before it passes a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def count_launch(wrapper, tally: dict | None = None, key=None) -> None:
    """Add one to ``wrapper.launches``, the launch count a kernel's wrapper
    carries, and to ``tally[key]`` where the wrapper also counts by route
    or shape (called where the wrapper launches its kernel, and nowhere
    else)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if tally is not None:
            tally[key] = tally.get(key, 0) + 1
