"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Every ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (``nvcc -shared``; no PyTorch headers, so each builds in
seconds).  All sources are compiled together, one ``nvcc`` process each,
the first time any kernel is launched (or when :func:`build_all` is called
directly).  Outputs go to ``_build/`` beside this file, named by a hash of
the sources and flags, so an unchanged tree reuses them.

Each C entry point takes its pointers and the CUDA stream as
``c_void_p``, its sizes as ``c_int``/``c_longlong``, launches on that
stream, and returns ``cudaGetLastError()``; :class:`Kernel` raises when
that is not 0 and otherwise adds one to its launch count.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("fps", "gather", "bandwidth", "mean_shift", "mean_shift_bwd",
           "nms", "max_bwd_cnt_gsm", "max_bwd_dz", "sr_bf16",
           "bn_relu_eval")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library, all in
    parallel; returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(names=SOURCES) -> str:
    """Compile ``csrc/<name>.cu`` for each of ``names`` with ``-Xptxas -v``
    into a temporary directory and return ptxas's lines per kernel:
    registers, spills, shared memory."""
    import tempfile

    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
                 "-o", str(Path(tmp) / f"{name}.so"),
                 str(CSRC / f"{name}.cu")],
                capture_output=True, text=True, check=True)
            lines = [ln.strip() for ln in (res.stdout + res.stderr)
                     .splitlines() if "ptxas" in ln or "spill" in ln]
            out.append(f"--- {name}.cu\n" + "\n".join(lines))
    return "\n".join(out)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.prifit_error_string.argtypes = [ctypes.c_int]
            lib.prifit_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def stream_handle(t) -> int:
    """The current CUDA stream of ``t``'s device, as the C entry points
    take it: PyTorch's raw-stream query, which skips building the
    ``torch.cuda.Stream`` object that ``torch.cuda.current_stream`` makes
    on every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_cuda(name: str, t, dtype=None, ndim=None, align: int = 16
               ) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    and rank (what every kernel takes), aligned to ``align`` bytes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")


P = ctypes.c_void_p
I32 = ctypes.c_int
U32 = ctypes.c_uint
I64 = ctypes.c_longlong
F32 = ctypes.c_float


class Kernel:
    """One hand-written kernel: its library (``csrc/<name>.cu``), its C
    entry points, and the number of launches made through it."""

    def __init__(self, name: str, replaces: str, entry_points: dict):
        self.name = name
        self.replaces = replaces
        self._argtypes = entry_points
        self._fns = {}
        self.launches = 0

    @property
    def source_path(self) -> str:
        return f"prifit_torch/kernels/csrc/{self.name}.cu"

    def launch(self, entry: str, *args) -> None:
        fn = self._fns.get(entry)
        if fn is None:
            lib = library(self.name)
            fn = getattr(lib, entry)
            fn.argtypes = list(self._argtypes[entry])
            fn.restype = ctypes.c_int
            self._fns[entry] = fn
        err = fn(*args)
        if err != 0:
            msg = library(self.name).prifit_error_string(err).decode()
            raise RuntimeError(f"{self.name}: {entry} failed to launch: "
                               f"CUDA error {err} ({msg})")
        self.launches += 1


if __name__ == "__main__":
    # python -m prifit_torch.kernels.build [name ...]: ptxas's registers,
    # spills and shared memory of each kernel (all sources by default)
    import sys

    print(ptxas_report(sys.argv[1:] or SOURCES))
