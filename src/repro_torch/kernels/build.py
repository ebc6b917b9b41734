"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library that ``ctypes`` loads — no
PyTorch headers, so a build takes seconds. Libraries are built at first
CUDA use from the sources in this package, into ``_build/`` beside this
file (ignored by git), and named by a hash of source and flags, so an
edited source is rebuilt and an unchanged one is not.

Nothing here runs at import: the CPU tests import every module on a
machine with neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I = ctypes.c_void_p, ctypes.c_int
# name -> C signatures (restype, argtypes) to declare on load.
SIGNATURES = {
    "mttkrp_compact": {
        "mttkrp_compact_launch": (_I, [_VP] * 6 + [_VP, _I] + [_I] * 5
                                  + [_VP, _VP, _VP, _I, _I]
                                  + [_VP, _VP, _VP, _VP]),
    },
}

#: name -> compiler output of the library's build (``-Xptxas -v``:
#: registers, shared memory and spills per kernel), kept beside the
#: library and read back when the library is already built.
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` as PyTorch resolves it, else
    the ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
    found = str(cand) if CUDA_HOME and cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; raises with the compiler's output if any build fails."""
    names = sorted(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and out.with_suffix(".log").exists():
            BUILD_LOG[name] = out.with_suffix(".log").read_text()
            continue
        tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        tmp.with_suffix(".log").write_text(log)
        os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every C
    function's argument and return types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
