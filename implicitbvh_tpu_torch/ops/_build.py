"""Build, load and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Libraries are built at
first use into ``build/kernels/`` beside the package (named by a hash of
the sources and flags, so an edited source builds anew); ``build()`` starts
one ``nvcc`` per source, all at once.  Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("band_bits", "run_counts", "group_emit", "group_contacts",
           "compact", "walk", "dfs", "ray_band_bits", "leader_group",
           "tree_build")
# -fmad=false: no FMA contraction anywhere (the predicates also use
# explicitly rounded intrinsics); -Xptxas -v reports registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    process each, all started together.  Returns ``{name: nvcc output}``
    for the sources it compiled; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        logs = {}
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
            os.replace(tmp, out)
            logs[name] = log
        return logs
    finally:
        for _, _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def kernel_fn(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of library ``name`` (built if needed),
    with its argument types declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


P = ctypes.c_void_p
I = ctypes.c_int


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (and of
    ``shape`` / on ``device`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_values(t: torch.Tensor, name: str, like=None,
                 device=None) -> int:
    """Raise unless ``t`` is a contiguous float32 or float64 tensor (of
    ``like``'s dtype when given, and on ``device``); returns the kernels'
    ``value_bits``, 32 or 64."""
    if like is not None:
        check(t, name, like.dtype, device=device)
    elif isinstance(t, torch.Tensor) and t.dtype in (torch.float32,
                                                     torch.float64):
        check(t, name, t.dtype, device=device)
    else:
        got = t.dtype if isinstance(t, torch.Tensor) else type(t).__name__
        raise TypeError(f"{name} must be torch.float32 or torch.float64, "
                        f"got {got}")
    return 64 if t.dtype == torch.float64 else 32


def cuda_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def launch(fn, name: str, *args):
    """Call a C launcher on the current stream; raise on a CUDA error."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
