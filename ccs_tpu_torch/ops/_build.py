"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, into ``ccs_tpu_torch/build/`` (listed in
``.gitignore``), and again whenever the sources change: the library's file
name carries a hash of the sources and flags. A failed build raises; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build printed (nvcc -Xptxas -v: registers, shared memory,
# spills per kernel); None when the library was already built
build_log: str | None = None


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand.append(os.path.join(root, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin); the CUDA scorer cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libccs_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for this source hash exists;
    return its path. Raises RuntimeError with nvcc's output on failure."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_log = proc.stdout + proc.stderr
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ccs_hmm_score_dense.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
        lib.ccs_hmm_score_dense.restype = i32
        lib.ccs_hmm_score_sparse.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        lib.ccs_hmm_score_sparse.restype = i32
        lib.ccs_hmm_launch_shape.argtypes = [i32] * 3 + [
            ctypes.POINTER(i32)] * 4
        lib.ccs_hmm_launch_shape.restype = i32
        lib.ccs_error_string.argtypes = [i32]
        lib.ccs_error_string.restype = ctypes.c_char_p
        lib.ccs_edit_distance_banded.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.ccs_edit_distance_banded.restype = i32
        lib.ccs_edit_max_band.argtypes = []
        lib.ccs_edit_max_band.restype = i32
        _lib = lib
        return lib


def launch_shape(T: int, C: int, R: int) -> tuple[int, int, int, int]:
    """(reads per group, dynamic shared-memory bytes per CTA, threads per
    CTA, CTAs that fit on an SM) of a scorer launch at these caps."""
    lib = load_library()
    out = [ctypes.c_int() for _ in range(4)]
    rc = lib.ccs_hmm_launch_shape(T, C, R, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise RuntimeError(f"ccs_hmm_launch_shape failed: CUDA error {rc} "
                           f"({error_string(rc)})")
    return tuple(o.value for o in out)


def error_string(code: int) -> str:
    """The CUDA runtime's text for an error code a kernel entry returned."""
    return load_library().ccs_error_string(code).decode()


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype, shape and
    device: a kernel entry takes raw pointers and checks nothing itself."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
