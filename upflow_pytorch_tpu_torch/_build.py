"""Build the CUDA kernels of ``csrc/`` and bind them with ctypes.

At first use every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its
own ``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The library goes to ``_build/<hash>/`` beside this file, keyed by a hash of
the sources and the flags, so a checkout builds once and an edited source
builds anew.  There is no ``--use_fast_math``: the warp kernels rely on
correctly rounded arithmetic.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libupflow_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


def _sources() -> List[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Runs the commands concurrently; raises if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append("$ %s\n%s" % (" ".join(cmd), out))
        if p.returncode != 0:
            failed.append("%s (exit %d)" % (cmd[-1], p.returncode))
    log = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (failed, log))
    return log


def build() -> Path:
    """Compiles the kernels if this source hash has no library yet;
    returns the library's path.  ``build.log`` beside it holds nvcc's and
    ptxas' output (registers, spills)."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c",
                         "-o", str(o), str(src)]
                        for o, src in zip(objs, _sources())])
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]])
        (out_dir / "build.log").write_text(log)
        os.replace(tmp_lib, lib_path)
    return lib_path


def kernel_fn(name: str, argtypes: Sequence,
              restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the kernel library (built and loaded
    at first call) with its ``argtypes`` set.  The launch entry points
    return the ``cudaGetLastError()`` code right after the launch."""
    global _lib
    if name not in _fns:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[name] = fn
    return _fns[name]


def check_launch(name: str, code: int) -> None:
    """Raises if a launch returned a CUDA error code."""
    if code != 0:
        err = kernel_fn("upflow_error_string", [ctypes.c_int],
                        restype=ctypes.c_char_p)
        raise RuntimeError("%s: CUDA launch failed (%d): %s"
                           % (name, code, err(code).decode()))
