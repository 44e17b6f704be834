"""Build and bind the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by its own `nvcc` process into
`build/repro_torch/lib<name>-<digest>.so` at the repo root, with a plain C
interface, and loaded with `ctypes`. The first launch of any kernel builds
every library that is missing, all compilers started together. The digest
covers the flags, the source and every header in `csrc/`, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs
at import: the package imports on machines with no `nvcc` and no card,
where only the plain PyTorch versions run.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -I csrc -o lib<name>-<digest>.so <name>.cu

`-Xptxas=-v` prints each kernel's registers, shared memory and spills into
the `.log` beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fir", "stft", "mmse", "fused_tail")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

MAX_GRID_Y = 65535      # CUDA's limit on gridDim.y (and z)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every listed source that has no current library, one `nvcc`
    each, all started together. Returns name -> library path; raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output (`-Xptxas=-v` resource usage) of the current
    build of `name`, or "" when it was built by an earlier process."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build()[name]))    # all, in parallel
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    The entry point takes the given argument types followed by the CUDA
    stream and returns a `cudaError_t` code; the launch is enqueued on the
    current stream of `device`. `launches` counts the launches that were
    accepted and nothing else, under a lock: threads of one process (an
    in-process worker pool) launch the same kernel, and `+= 1` on an
    attribute is not atomic."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.launches = 0
        self._fn = None
        self._count_lock = threading.Lock()

    def __call__(self, device: torch.device, *args):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = load(self.source).repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        with self._count_lock:
            self.launches += 1


def require_cuda(*tensors, dtype=torch.float32):
    """Raise unless every tensor is a contiguous `dtype` tensor on one CUDA
    device; returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dtype}, got {t.dtype} "
                             f"(contiguous={t.is_contiguous()})")
    return dev
