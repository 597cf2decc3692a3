"""Build and load the port's CUDA kernels, and count their launches.

The sources under ``davo_tpu_torch/csrc/`` have a plain ``extern "C"``
interface and include no PyTorch header, so ``nvcc`` builds them in
seconds.  At first use each source is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together), the objects are linked into one
shared library under ``build/davo_tpu_torch/`` (named by a hash of the
sources and flags, so a changed source is never served a stale build),
and the library is loaded with ``ctypes``.  A file lock keeps two
processes from building at once.  A missing ``nvcc`` or a failed build
raises with the compiler's output; nothing falls back.

Each kernel wrapper adds one to its entry of :data:`launch_counts` where
it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "load_library",
    "build_log",
    "check_launch",
]

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "davo_tpu_torch"
SOURCES = (
    "bfgs_update.cu",
    "bfgs_update_variants.cu",
    "calibration_obj.cu",
    "calibration_dirderiv.cu",
    "match_attention.cu",
)
# headers the sources include (part of the build's hash)
HEADERS = ("calibration_common.cuh",)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset
launch_counts: Dict[str, int] = {
    "bfgs_update": 0,
    "bfgs_update_rowloop": 0,
    "bfgs_update_rowloop2": 0,
    "calibration_value_and_grad": 0,
    "calibration_value_and_dirderiv": 0,
    "match_attention": 0,
}

_library: Optional[ctypes.CDLL] = None
# what the last build printed: seconds, and the ptxas register/spill lines
build_log: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # h, h_out, s, y, g, updating, d, B, P, is_first, is_second, h_is_bf16, stream
    "davo_bfgs_update_direction": [_P] * 7 + [_I] * 5 + [_P],
    # h, h_out, s, y, g, updating, d, B, P, is_first, is_second, h_is_bf16,
    # scale_rows, elems_per_block, stream
    "davo_bfgs_update_variant": [_P] * 7 + [_I] * 7 + [_P],
    # params, u, v, vis, err, grad, B, M, N, stream
    "davo_calibration_value_and_grad": [_P] * 6 + [_I] * 3 + [_P],
    # params, direction, u, v, vis, err, dphi, B, M, N, stream
    "davo_calibration_value_and_dirderiv": [_P] * 7 + [_I] * 3 + [_P],
    # query, key, value, mask (or null), out, B, Q, K, D, C, stream
    "davo_match_attention": [_P] * 5 + [_I] * 5 + [_P],
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the port's CUDA kernels are built with it at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(nvcc: str, library: Path) -> None:
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    ptxas: List[str] = []
    failures = []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        ptxas += [ln.strip() for ln in out.splitlines() if "ptxas" in ln]
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n" + "\n".join(failures))
    tmp_lib = work / library.name
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)]
    link = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the CUDA kernels:\n$ {' '.join(cmd)}\n{link.stdout}")
    os.replace(tmp_lib, library)
    shutil.rmtree(work, ignore_errors=True)
    build_log.update(seconds=time.perf_counter() - start, ptxas=ptxas)
    (library.with_suffix(".ptxas.txt")).write_text("\n".join(ptxas) + "\n")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _library
    if _library is not None:
        return _library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    library = BUILD_DIR / f"libdavo_kernels_{_digest()}.so"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not library.exists():
            _build(_nvcc(), library)
        else:
            log = library.with_suffix(".ptxas.txt")
            build_log.update(seconds=0.0, ptxas=log.read_text().splitlines() if log.exists() else [])
        lib = ctypes.CDLL(str(library))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.davo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    _library = lib
    return lib


def check_launch(status: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        reason = load_library().davo_cuda_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: cudaError {status} ({reason})")
