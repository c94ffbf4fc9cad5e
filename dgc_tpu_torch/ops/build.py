"""Build and load the port's CUDA C++ kernels.

Each ``dgc_tpu_torch/csrc/*.cu`` file exposes a plain C launch function and
is compiled by ``nvcc`` into its own shared library, loaded with
:mod:`ctypes` (no PyTorch headers: a build takes seconds, not minutes).
Libraries land in ``build/kernels/`` at the root of the checkout, named by
a hash of their source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source is rebuilt and an unchanged one is reused. :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no CUDA toolkit.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
#: one shared library per source file
SOURCES = ("topk_rows.cu", "apply_rows.cu", "opaque_copy.cu",
           "select_pack_rows.cu", "dgc_forward_rows.cu", "ladder_counts.cu",
           "seg_top2.cu", "compensate.cu")
# no --use_fast_math: the apply kernel's divide must stay IEEE
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from dgc_tpu_torch/csrc")


def _target(src: str) -> Path:
    text = (CSRC / src).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(text + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(src).stem}-{h}.so"


def build(sources: Iterable[str] = SOURCES,
          verbose: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel.
    Returns ``{source: library path}``. With ``verbose``, ``ptxas`` prints
    each kernel's registers and shared memory, and that output is returned
    on stdout. Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s: _target(s) for s in sources}
    procs = []
    for src, lib in out.items():
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, lib)
        if verbose and log:
            print(f"[nvcc {src}]\n{log.strip()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(src: str, argtypes: Optional[Dict[str, list]] = None
            ) -> ctypes.CDLL:
    """The loaded library of one source (built on first use), with the
    given ``{function: argtypes}`` set and every return type ``c_int``."""
    lib = _loaded.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build([src])[src]))
        for fn, types in (argtypes or {}).items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[src] = lib
    return lib
