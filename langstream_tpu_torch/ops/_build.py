"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. At first use it is
compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/`` at the repository root (one
shared library per source, named by a hash of the source and the flags, so
an edited source never loads a stale build) and loaded with ``ctypes``.
Only sources in the repository are compiled; ``build_all`` starts one
``nvcc`` per source at once. Nothing is built when a module is imported.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong

# source stem → {C symbol: argtypes}; every symbol returns a cudaError_t as int
SOURCES: dict[str, dict[str, list]] = {
    "flash_segment": {
        "lstpu_flash_segment": [
            _p, _p, _p, _p, _p, _p, _p,
            _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _f, _f, _i, _p,
        ],
    },
    "ragged_decode": {
        "lstpu_decode": [
            _p, _p, _p, _p, _p, _p, _p, _p,
            _i, _i, _i, _i, _i, _i, _i, _i, _i, _ll, _ll, _ll, _ll,
            _i, _i, _i, _i, _i, _i, _f, _f, _p,
        ],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names: tuple[str, ...] = tuple(SOURCES)) -> dict[str, float]:
    """Compile every named source that has no current build, one ``nvcc``
    per source started together; returns the seconds each build took
    (0.0 where a current build was found). Raises with the compiler's output
    when a build fails. The ptxas report (registers, shared memory, spills)
    is kept beside each library as ``<name>-<hash>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    started = {}
    t0 = time.monotonic()
    for name in names:
        if not library_path(name).exists():
            started[name] = _start(name)
    failures = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with the
    argument types of every symbol declared. Once loaded, a launch reads it
    without taking the lock."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for sym, argtypes in SOURCES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


# cudaError_t values that leave the context unusable: every later call in
# the process fails too (an illegal address, a device-side trap, ...)
STICKY_ERRORS = frozenset({700, 710, 714, 715, 716, 717, 718, 719})


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a CUDA error; ``sticky`` when the
    context cannot recover from it in this process."""

    def __init__(self, what: str, code: int) -> None:
        super().__init__(f"{what} failed to launch: cudaError_t {code}")
        self.code = code
        self.sticky = code in STICKY_ERRORS


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point reports a CUDA error. Host-side only
    (it reads the returned code), so it is safe inside a graph capture."""
    if err != 0:
        raise KernelLaunchError(what, err)
