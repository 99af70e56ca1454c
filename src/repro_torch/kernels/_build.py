"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, never at import, into ``build/repro_torch/``
under the repository root (listed in ``.gitignore``); each library's file
name carries a hash of its source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  :func:`build` compiles several sources in
parallel, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel source of the package, by library name
SOURCES = ("ell_spmm", "varco_pack", "varco_pack_quant", "randmask",
           "flash_attention", "flash_attention_mma", "flash_attention_wgmma",
           "ssd_chunk")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on ``PATH``, else the toolkit's
    default location.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """The library's file: its name carries a hash of the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns ``{"seconds": wall time,
    "log": {name: compiler output}}``; raises with the compiler's output
    if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    log, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)      # atomic: readers never see half a file
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(log[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "log": log}


def library(name: str, functions: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes``/``restype`` set from ``functions``: ``{symbol:
    [argtypes]}``, every symbol returning a C ``int`` (the CUDA error
    code of its launch)."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for sym, argtypes in functions.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
