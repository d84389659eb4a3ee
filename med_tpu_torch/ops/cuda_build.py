"""Build and load the hand-written CUDA kernels of ``med_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for Hopper (``sm_90a``) into ``med_tpu_torch/build/lib<name>-<hash>.so`` at
first use and loaded with ``ctypes``; the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source builds anew. Nothing here runs at import: the
CPU tests import every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
KERNELS = ("swa_packed_fwd", "swa_packed_bwd", "tcn_stack_fwd", "tcn_stack_bwd",
           "resnet_stage", "swa_headmajor_fwd", "swa_headmajor_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns the compiler's
    output (register and shared-memory use, from ``-Xptxas -v``) by name;
    raises with that output when a compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    running = {}
    logs: Dict[str, str] = {}
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, so)
        for name, (proc, tmp, so) in running.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{logs[name]}")
            os.replace(tmp, so)
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return logs


def kernel_function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name``, built and loaded
    on first use, with its ``argtypes`` declared and an ``int`` (a
    ``cudaError_t``) as its result."""
    if (name, symbol) not in _functions:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_loaded[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return _functions[(name, symbol)]


def check_operand(name: str, t, device, dtype) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``:
    the kernels take raw pointers and assume that layout."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}; got {t.dtype} on {t.device}, "
                         f"contiguous={t.is_contiguous()}")


def check_launch(name: str, symbol: str, code: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        err = getattr(_loaded[name], f"{symbol}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{symbol} launch failed: CUDA error {code} "
            f"({err(code).decode()})")
