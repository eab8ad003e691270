"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` for ``sm_90a`` (all started
together), then linked into one shared library with a plain C interface
and loaded with ``ctypes``.  Nothing includes PyTorch's headers, so a cold
build takes seconds, not minutes.

The library lands in ``build/repro_torch_kernels/`` at the repository
root, at first use, under a name that carries the hash of the sources and
flags: an edited source builds anew, an unchanged one is loaded as is.  A
missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
CUDA_ROOTS = ("/usr/local/cuda",)      # searched after PATH and CUDA_HOME
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C signature of every launcher: pointers and the stream as ``c_void_p``
#: (so ctypes never cuts a 64-bit address), sizes as ``c_int``/``c_longlong``,
#: scales as ``c_float``.
#: Each launcher returns the ``cudaError_t`` of its launch;
#: ``paged_attention_splits`` returns the split count the launcher uses.
SIGNATURES = {
    "merge_sorted_launch": (P, P, P, P, P, P, I, I, I, I, I, P),
    "sorted_search_launch": (P, P, P, P, P, P, I, I, P),
    "sorted_search_rows_launch": (P, P, LL, P, P, P, P, P, P, I, P),
    "bloom_probe_launch": (P, P, P, I, I, I, P),
    "bloom_probe_rows_launch": (P, LL, P, P, P, I, I, I, P),
    "bloom_build_launch": (P, P, P, I, I, I, I, P),
    "range_scan_launch": (P, P, I, P, P, P, P, P, I, I, P),
    "range_scan_rows_launch": (P, P, LL, P, P, P, P, P, P, P, I, I, I, P),
    "paged_attention_launch": (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F,
                               I, I, P),
    "paged_attention_splits": (I, I, I),
    "empty_launch": (P,),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from csrc/ at first use and need the CUDA "
                       "toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (skipped when the hashed library exists)."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)       # atomic: concurrent builds agree
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.repro_torch_error_string.argtypes = [ctypes.c_int]
    lib.repro_torch_error_string.restype = ctypes.c_char_p
    return lib


def require(name: str, t, dtype, ndim: int, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and rank
    (on ``device`` when given): the only inputs the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name: str, device, *args) -> None:
    """Call one launcher on ``device``'s current stream (appended as the
    last argument) and raise on the ``cudaError_t`` it returns."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.repro_torch_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
