"""ctypes bindings for the native C++ data path (``native/upflow_native.cc``).

Port of ``upflow_pytorch_tpu/data/native.py``: PNG inflate and unfilter,
the KITTI flow PNG decode and the UnFlow normalisation in C++, the host
side of the input pipeline.  The source is read from ``native/`` and never
written there: at first use it is compiled with g++ and ``native/
Makefile``'s flags,

    g++ -O3 -fPIC -std=c++17 -Wall -march=native upflow_native.cc
        -o libupflow_native.so -shared -lz

into ``_build/native/<hash of the source, the flags and the CPU's
features>/`` beside this package, under a temporary name that is then
renamed into place, so two processes building at once never load a torn
library, and a checkout shared by two machines builds for each.

Every entry point keeps the JAX package's semantics: without the library
(no compiler, no zlib) it falls back to the Python codec of ``flow_io``.
The state is reported, never guessed: ``available()`` says whether the
library loaded, ``library_path()`` where it is and ``build_error()`` the
compiler's last lines when the build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "upflow_native.cc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build" / "native"
LIB_NAME = "libupflow_native.so"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native"]
LDFLAGS = ["-shared", "-lz"]
ERROR_LINES = 20

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_lib_lock = threading.Lock()


class _PngInfo(ctypes.Structure):
    _fields_ = [("width", ctypes.c_uint32), ("height", ctypes.c_uint32),
                ("channels", ctypes.c_uint32), ("bitdepth", ctypes.c_uint32)]


def _cpu_key() -> bytes:
    """``-march=native`` builds for this CPU: its feature flags (or, where
    /proc/cpuinfo is not readable, its architecture) key the build."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU is
    built."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(_cpu_key())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _build(lib_path: Path) -> None:
    """Compiles the library into ``lib_path``; raises ``RuntimeError``
    with the compiler's last lines when it cannot."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ is not on PATH")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp_lib), *LDFLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError("%s: %s" % (" ".join(cmd), e)) from e
        if proc.returncode != 0 or not tmp_lib.is_file():
            log = (proc.stdout + proc.stderr).strip().splitlines()
            raise RuntimeError("%s (exit %d):\n%s" % (
                " ".join(cmd), proc.returncode,
                "\n".join(log[-ERROR_LINES:])))
        os.replace(tmp_lib, lib_path)


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded at the first call; None when
    it cannot be built or loaded (``build_error()`` says why)."""
    global _lib, _tried, _error
    if _tried:
        return _lib
    with _lib_lock:
        if _tried:
            return _lib
        try:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            _tried = True
            return None
        lib.un_decode_png.restype = ctypes.c_int
        lib.un_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_PngInfo),
            ctypes.c_void_p, ctypes.c_size_t]
        lib.un_decode_flow_png.restype = ctypes.c_int
        lib.un_decode_flow_png.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_PngInfo),
            ctypes.c_void_p, ctypes.c_void_p]
        lib.un_preprocess_image.restype = None
        lib.un_preprocess_image.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        _lib = lib
        _tried = True
        return lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (the compiler's last lines, or the
    loader's error), or None when it loaded or was not tried yet."""
    return _error


def _parse(lib: ctypes.CDLL, path: str) -> Tuple[bytes, _PngInfo]:
    with open(path, "rb") as f:
        data = f.read()
    info = _PngInfo()
    rc = lib.un_decode_png(data, len(data), ctypes.byref(info), None, 0)
    if rc != 0:
        raise IOError("native PNG parse failed (%d): %s" % (rc, path))
    return data, info


def decode_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, C) uint8/uint16 via the C++ decoder."""
    lib = get_lib()
    if lib is None:
        from upflow_pytorch_tpu_torch.data.flow_io import read_png
        return read_png(path)
    data, info = _parse(lib, path)
    dtype = np.uint16 if info.bitdepth == 16 else np.uint8
    out = np.empty((info.height, info.width, info.channels), dtype)
    rc = lib.un_decode_png(data, len(data), ctypes.byref(info),
                           out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise IOError("native PNG decode failed (%d): %s" % (rc, path))
    return out


def decode_flow_png(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI flow PNG -> (flow (H,W,2) f32, valid (H,W,1) u8) via C++."""
    lib = get_lib()
    if lib is None:
        from upflow_pytorch_tpu_torch.data.flow_io import read_flow_png
        return read_flow_png(path)
    data, info = _parse(lib, path)
    flow = np.empty((info.height, info.width, 2), np.float32)
    valid = np.empty((info.height, info.width, 1), np.uint8)
    rc = lib.un_decode_flow_png(data, len(data), ctypes.byref(info),
                                flow.ctypes.data_as(ctypes.c_void_p),
                                valid.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError("native flow decode failed (%d): %s" % (rc, path))
    return flow, valid


def preprocess_image(img: np.ndarray, horizontal_flip: bool = False
                     ) -> np.ndarray:
    """uint8 RGB HWC -> UnFlow-normalized float32 HWC via C++."""
    lib = get_lib()
    if lib is None:
        from upflow_pytorch_tpu_torch.data.image_io import normalize_image
        return normalize_image(img, True, horizontal_flip)
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("expected an (H, W, 3) image, got %s"
                         % (img.shape,))
    h, w = img.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    lib.un_preprocess_image(img.ctypes.data_as(ctypes.c_void_p), h, w,
                            1 if horizontal_flip else 0,
                            out.ctypes.data_as(ctypes.c_void_p))
    return out
