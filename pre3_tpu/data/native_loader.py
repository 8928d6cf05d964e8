"""ctypes binding for the native SR4000 frame decoder.

The hot-path data loader of the engine: native C++ (native/sr4000_loader.
cc) parses and preprocesses frames with a thread pool so host IO overlaps
device compute — replacing the reference's MATLAB readers + per-frame
.mat disk caches (read_xyz_sr4000.m:47-50). Auto-builds via `make` on
first use; falls back to the pure-numpy parser (data/sr4000.py) when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

from pre3_tpu.data.sr4000 import H, W, Frame, read_frame

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libsr4000.so")


@lru_cache(maxsize=1)
def _load_lib():
    """Build (if needed) and load the native library; None on failure."""
    try:
        if not os.path.exists(_LIB_PATH):
            # build into a private directory, then rename into place:
            # concurrent first users never load a half-written library
            tmp = f"build/tmp.{os.getpid()}"
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"BUILD={tmp}"],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(os.path.join(_NATIVE_DIR, tmp, "libsr4000.so"),
                       _LIB_PATH)
            os.rmdir(os.path.join(_NATIVE_DIR, tmp))
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.sr4000_decode.restype = ctypes.c_int
    lib.sr4000_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.sr4000_decode_batch.restype = ctypes.c_int
    lib.sr4000_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_frame_native(path: str, smooth: bool = True) -> Frame:
    """Decode one frame via the native library (numpy fallback if absent)."""
    lib = _load_lib()
    if lib is None:
        return read_frame(path, smooth=smooth)
    intensity = np.empty((H, W), np.float32)
    xyz = np.empty((H, W, 3), np.float32)
    conf = np.empty((H, W), np.float32)
    ts = ctypes.c_double()
    rc = lib.sr4000_decode(
        path.encode(), _fptr(intensity), _fptr(xyz), _fptr(conf),
        ctypes.byref(ts), int(smooth),
    )
    if rc != 0:
        raise IOError(f"sr4000_decode({path}) failed with code {rc}")
    return Frame(
        intensity=intensity, xyz=xyz, confidence=conf, timestamp=ts.value
    )


def read_sequence_native(
    paths: list[str], smooth: bool = True, threads: int = 0
) -> list[Frame]:
    """Decode a frame batch with the native thread pool."""
    lib = _load_lib()
    if lib is None:
        return [read_frame(p, smooth=smooth) for p in paths]
    n = len(paths)
    intensity = np.empty((n, H, W), np.float32)
    xyz = np.empty((n, H, W, 3), np.float32)
    conf = np.empty((n, H, W), np.float32)
    ts = np.empty((n,), np.float64)
    status = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.sr4000_decode_batch(
        c_paths, n, _fptr(intensity), _fptr(xyz), _fptr(conf),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(smooth), threads,
    )
    bad = np.nonzero(status != 0)[0]
    if len(bad):
        raise IOError(
            f"sr4000_decode_batch: {len(bad)} frames failed, first: "
            f"{paths[bad[0]]} rc={status[bad[0]]}"
        )
    return [
        Frame(intensity=intensity[i], xyz=xyz[i], confidence=conf[i],
              timestamp=float(ts[i]))
        for i in range(n)
    ]
