"""Build, load and launch the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per source,
all started together, then linked into one shared library with a plain C
interface and loaded with ``ctypes``. The library is built at first use into
``_build/`` beside this file (listed in ``.gitignore``), under a name that
hashes the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing is built when this module is imported.

Each C entry point takes its pointers and the CUDA stream as ``void*``,
launches on PyTorch's current stream, does not synchronise, and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and only
then counts the launch in :data:`launches`.

The kernels of the forward (K1 FPS, K2 the merge layer's NN scan) are also
custom operators, ``rfnet::fps`` and ``rfnet::nn_coords``
(:func:`define_op`), which their wrappers call for CUDA tensors: through
them ``torch.export`` records the kernels in an exported program, where it
cannot trace a ``ctypes`` call. The ops are defined when ``ops.fps`` and
``ops.chamfer`` are imported; nothing is built then either.

Where the environment names a file in ``RFNET_LAUNCH_LOG``, each process
that imports this module appends its :data:`launches` to it at exit, one
JSON line (``pid``, ``argv``, ``launches``): how a caller counts the
launches of CLI runs in other processes (``tools/protocol_drive_torch.py``'s
stages).
"""

from __future__ import annotations

import atexit
import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each kernel entry point (all return int = cudaError_t)
_SIGNATURES = {
    # xyz, b, n, npoint, CTAs a cloud, points a thread (0 = streaming),
    # scratch (streaming form), idx_out, stream
    "fps": (_P, _I, _I, _I, _I, _I, _P, _P, _P),
    # query, target, b, n, m, the plan (queries a thread, query warps a CTA,
    # warps splitting its targets, CTAs a cluster, tiles), dist_out, idx_out,
    # coords_out, stream
    "nn_coords": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # query_sorted, target_sorted, b, n, m, slab, dist_out, idx_out, the
    # loaded pairs' counter (int64; null: not counted), stream
    "nn_dyn": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # query, target, b, n, m, the plan as for nn_coords, dist_out, idx_out,
    # stream
    "nn_dense": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # x1, g, idx (int32), b, n, m, blocks a cloud, scratch, its ints a block,
    # sp_out, sw_out, stream
    "nn_grad": (_P, _P, _P, _I, _I, _I, _I, _P, _L, _P, _P, _P),
    # xyz1, xyz2 (spatially sorted), their tile boxes (scratch), b, n, m,
    # tile, parts, multi_l, multi_r, remain_l, ratio_l, rowcost, remain_r,
    # ratio_r, part_sums (scratch), cost_out, band_skip, stream
    "emd_cost": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    # query_sorted, target_sorted, box scratch, b, n, m, the plan (warps a
    # block, targets a tile), dist_out, idx_out, tiles staged per block out,
    # stream
    "nn_pruned": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "nn_tile": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # query, target, b, n, m, the plan (R, G, W, C, tiles: K4's for v0,
    # K9's own for v1-v3), fma, eq_argmin, dist_out, idx_out, stream (K9,
    # the variant study's scan)
    "nn_variant": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # query, target, b, n, m, k, dist_out, idx_out, stream (K10, the k
    # nearest neighbours of SnowflakeNet's grouping)
    "knn": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # pos, idx (int32), query, key, value, the packed weights, b, n, CTAs at
    # most, out, stream (K11, SnowflakeNet's vector attention after its k-NN)
    "attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
}

# launches of each kernel since the last reset_launch_counts()
launches: dict[str, int] = {name: 0 for name in _SIGNATURES}

_lib = None
_lib_lock = threading.Lock()

# the namespace of the custom operators (``torch.ops.rfnet``), registered
# through ``torch.library.Library``: on an H100 machine's host it adds ~5 us
# a call of K1 at (4,3000)->32 to the body's, ``torch.library.custom_op``
# ~29 us (chip_smoke.py, op_overhead)
_OPS = torch.library.Library("rfnet", "DEF")


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


LAUNCH_LOG_ENV = "RFNET_LAUNCH_LOG"


def _append_launch_log(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv, "launches": launches}) + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_append_launch_log, os.environ[LAUNCH_LOG_ENV])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)"
    )


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librfnet_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the shared library if it is not built yet.

    Returns the library's path. The compiler's output (including ptxas'
    register and shared-memory report) is kept in ``_build/build.log``.
    Safe when several processes build at once: each builds in its own temporary
    directory and renames the result into place.
    """
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ))
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        failed = [
            f"{src}:\n{log}"
            for src, p, log in zip(_sources(), procs, logs) if p.returncode
        ]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
        with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, "rfnet_" + name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.rfnet_error_string.argtypes = [ctypes.c_int]
            lib.rfnet_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry ``rfnet_<name>`` on ``device``'s current stream.

    ``args`` are the entry's arguments before the stream: tensors are passed
    by data pointer, ints as ints. The caller validates shapes, dtypes,
    devices and contiguity and keeps the tensors alive across the call.
    """
    lib = _library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "rfnet_" + name)(*c_args, stream)
    if err:
        msg = lib.rfnet_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel rfnet_{name} failed: error {err} ({msg})")
    launches[name] += 1


def define_op(schema: str, cuda_impl, fake_impl) -> None:
    """Define the operator ``rfnet::<schema>``: ``cuda_impl`` runs it on CUDA
    tensors (it launches the kernel, and only there is the launch counted)
    and ``fake_impl`` gives its outputs' shapes and dtypes alone, for
    tracing. It has no CPU kernel: a wrapper runs the plain version for CPU
    tensors, which traces as ATen ops."""
    name = schema.split("(", 1)[0]
    _OPS.define(schema)
    _OPS.impl(name, cuda_impl, "CUDA")
    torch.library.register_fake(f"rfnet::{name}", fake_impl, lib=_OPS)
