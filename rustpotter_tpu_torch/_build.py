"""Build the package's CUDA sources at first use.

Each source under csrc/ is compiled by `nvcc` into a shared library with a
plain C interface and loaded with ctypes. Compile-time constants (-D) are part
of a build: a library is keyed by a hash of the source text and the flags, and
lands in _build/ (listed in .gitignore). Nothing here runs at import, and
nothing falls back: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the toolkit's
    default install prefix."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(defines: dict) -> list:
    return list(NVCC_FLAGS) + [f"-D{k}={v}" for k, v in sorted(defines.items())]


def library_path(source: str, defines: dict) -> Path:
    src = CSRC / source
    key = hashlib.sha256(
        src.read_bytes() + " ".join(_flags(defines)).encode()
    ).hexdigest()[:16]
    return BUILD / f"{src.stem}-{key}.so"


def build(source: str, defines: dict) -> Path:
    """Compile csrc/<source> with the given -D constants unless a library of
    the same source and flags exists. The compiler's report (ptxas registers,
    spills) is kept beside it as a .log file."""
    out = library_path(source, defines)
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(
        [nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} {defines}:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def build_log(source: str, defines: dict) -> str:
    return library_path(source, defines).with_suffix(".log").read_text()


def load(source: str, defines: dict) -> ctypes.CDLL:
    """The loaded library for (source, defines), built on first use."""
    key = (source, tuple(sorted(defines.items())))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(str(build(source, defines)))
        return lib
