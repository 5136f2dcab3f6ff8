"""Build the package's native sources at first use.

Each source under csrc/ is compiled into a shared library with a plain C
interface and loaded with ctypes: a CUDA source (.cu) by `nvcc` for sm_90a,
a host C++ source (.cpp) by the host compiler. Compile-time constants (-D)
are part of a build: a library is keyed by a hash of the source text (with
the csrc/ headers a .cu may include), the flags and the compiler's identity
(its path and its `--version`), so a library built by another toolkit is
never loaded. It lands in _build/
(listed in .gitignore). Nothing is compiled at
import, and nothing falls back: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
# The most shared memory one block may use on sm_90: 227 KB, as dynamic shared
# memory after cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...).
# Defined once, in csrc/smem.cuh, for the kernels and their wrappers.
SMEM_OPTIN = int(re.search(r"^constexpr int SMEM_OPTIN = (\d+);$",
                           (CSRC / "smem.cuh").read_text(), re.M).group(1))

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


def cxx() -> str:
    """The host C++ compiler: $CXX, then g++ on PATH."""
    cand = os.environ.get("CXX") or shutil.which("g++")
    if not cand:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    return cand


def _is_cuda(source: str) -> bool:
    return source.endswith(".cu")


def _compiler(source: str) -> str:
    return nvcc() if _is_cuda(source) else cxx()


_identities: dict = {}


def compiler_identity(compiler: str) -> str:
    """The compiler's path and `--version` text, read once per process."""
    ident = _identities.get(compiler)
    if ident is None:
        res = subprocess.run([compiler, "--version"], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{compiler} --version failed:\n{res.stderr}")
        ident = _identities[compiler] = f"{compiler}\n{res.stdout}"
    return ident


def _flags(source: str, defines: dict) -> list:
    base = NVCC_FLAGS if _is_cuda(source) else CXX_FLAGS
    return list(base) + [f"-D{k}={v}" for k, v in sorted(defines.items())]


def library_path(source: str, defines: dict) -> Path:
    src = CSRC / source
    stamp = compiler_identity(_compiler(source)) + " ".join(_flags(source, defines))
    text = src.read_bytes()
    if _is_cuda(source):
        text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(text + stamp.encode()).hexdigest()[:16]
    return BUILD / f"{src.stem}-{key}.so"


def build(source: str, defines: dict) -> Path:
    """Compile csrc/<source> with the given -D constants unless a library of
    the same source and flags exists. The compiler's report (for CUDA, ptxas
    registers and spills) is kept beside it as a .log file."""
    out = library_path(source, defines)
    if out.exists():
        return out
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    compiler = _compiler(source)
    res = subprocess.run(
        [compiler, *_flags(source, defines), "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(f"{compiler} failed for {source} {defines}:\n{res.stderr}")
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
