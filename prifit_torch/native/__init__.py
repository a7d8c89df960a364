"""Native (C++) host-side runtime pieces, bound via ctypes.

The port's copy of ``prifit_tpu/native``: the text point-file parser the
input pipeline calls for every ShapeNet-Part shape (``fastio.cpp``).  It
is a host parser, not a device kernel.  It is compiled at first use with
``g++ -O3 -shared`` into ``_build/`` beside this file (gitignored; the
library name carries a hash of the source, so a changed source rebuilds),
and the first call logs which parser runs.  Without a compiler the
numpy parser (``np.loadtxt``) takes its place.
"""

import ctypes
import hashlib
import logging
import os
import os.path as osp
import subprocess
import threading

import numpy as np

_HERE = osp.dirname(osp.abspath(__file__))
BUILD_DIR = osp.join(_HERE, "_build")
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False
_LOGGED = False
_log = logging.getLogger(__name__)


def _lib_path() -> str:
    src = osp.join(_HERE, "fastio.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return osp.join(BUILD_DIR, f"libfastio-{digest}.so")


def _build_library() -> str | None:
    out = _lib_path()
    if osp.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name and rename: concurrent first uses (test
    # workers, loader threads of other processes) never load a partial file
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
             osp.join(_HERE, "fastio.cpp")],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def _get_lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        path = _build_library()
        if path is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _LIB_FAILED = True
            return None
        lib.parse_floats_file.restype = ctypes.c_long
        lib.parse_floats_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
        ]
        _LIB = lib
    return _LIB


def parser_name() -> str:
    """Which parser :func:`fast_loadtxt` runs: ``"native"`` (the g++
    build of ``fastio.cpp``) or ``"numpy"`` (no compiler or library)."""
    return "native" if _get_lib() is not None else "numpy"


def _log_parser_once() -> None:
    global _LOGGED
    if not _LOGGED:
        _LOGGED = True
        if parser_name() == "native":
            _log.info("point files parsed by the native parser (%s)",
                      _lib_path())
        else:
            _log.warning("point files parsed by np.loadtxt: the native "
                         "parser did not build (no g++?)")


def fast_loadtxt(path: str, ncols: int | None = None) -> np.ndarray:
    """Parse a whitespace/comma-separated float text file into ``[-1,
    ncols]`` float32 (columns inferred from the first line when not
    given), with the native parser, else ``np.loadtxt``."""
    _log_parser_once()
    lib = _get_lib()
    if lib is None:
        out = np.loadtxt(path, delimiter=_sniff_delim(path)).astype(
            np.float32)
        # match the native path's guaranteed 2-D shape
        return out.reshape(-1, ncols if ncols else _sniff_ncols(path))

    # generous first guess: file size / 2 bytes-per-value upper bound
    cap = max(os.path.getsize(path) // 2, 64)
    buf = np.empty(cap, dtype=np.float32)
    n = lib.parse_floats_file(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap)
    if n < 0:
        raise IOError(f"cannot read {path}")
    if n > cap:  # extremely dense file; retry exactly sized
        buf = np.empty(n, dtype=np.float32)
        n = lib.parse_floats_file(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    vals = buf[:n]
    if ncols is None:
        ncols = _sniff_ncols(path)
    return vals.reshape(-1, ncols)


def _sniff_delim(path: str) -> str | None:
    with open(path) as f:
        return "," if "," in f.readline() else None


def _sniff_ncols(path: str) -> int:
    with open(path) as f:
        line = f.readline().replace(",", " ")
    return len(line.split())
