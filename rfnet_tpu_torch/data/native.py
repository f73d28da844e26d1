"""ctypes bridge to the native .pcd codec (``native/pcd_codec.cpp``).

The JAX package's ``rfnet_tpu/data/native.py``, for the port: the C++
source is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``rfnet_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
hashes the source, and loaded with ``ctypes`` (:func:`build_shared`, which
``visu.render_balls`` builds its rasteriser with too). Nothing is built when this
module is imported. A failed build is reported once on stderr, and
:func:`read_pcd_native` then returns None, so ``pcd_io.read_pcd`` falls back
to its numpy parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "pcd_codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
# files read by the native codec since the process started
reads = 0


def build_shared(source: str, stem: str) -> str:
    """Compile the C++ ``source`` with ``g++ -O3 -shared -fPIC`` into
    ``BUILD_DIR/lib<stem>_<hash of the source>.so`` if it is not built yet;
    returns the library's path. Raises RuntimeError with the compiler's
    message. Safe when several processes build at once: each compiles in its
    own temporary directory and renames a whole file into place."""
    if not os.path.exists(source):
        raise RuntimeError(f"source {source} not found")
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(so):
        return so
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp_so = os.path.join(tmp, "lib.so")
        res = subprocess.run([compiler, "-O3", "-shared", "-fPIC", "-o", tmp_so, source],
                             capture_output=True, text=True, timeout=120)
        if res.returncode:
            raise RuntimeError(f"g++ failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def _build() -> str:
    return build_shared(SOURCE, "pcdcodec")


def get_lib() -> ctypes.CDLL | None:
    """The loaded codec, built at first call; None if it could not be built
    or loaded (reported once on stderr)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as exc:
            print(f"rfnet_tpu_torch: the native .pcd codec is unavailable, reading .pcd files "
                  f"with the numpy parser ({exc})", file=sys.stderr)
            return None
        lib.pcd_count.argtypes = [ctypes.c_char_p]
        lib.pcd_count.restype = ctypes.c_long
        lib.pcd_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        lib.pcd_read.restype = ctypes.c_long
        _lib = lib
        return _lib


def read_pcd_native(filename: str) -> np.ndarray | None:
    """The (n, 3) xyz of ``filename`` as float64, read by the C++ codec;
    None where the codec is unavailable or refuses the file."""
    global reads
    lib = get_lib()
    if lib is None:
        return None
    path = os.fsencode(filename)
    n = lib.pcd_count(path)
    if n < 0:
        return None
    buf = np.empty((max(n, 1), 3), dtype=np.float32)
    got = lib.pcd_read(path, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got < 0:
        return None
    with _lock:
        reads += 1
    return buf[:got].astype(np.float64)
