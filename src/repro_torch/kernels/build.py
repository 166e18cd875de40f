"""Build and load the port's hand-written CUDA kernels.

Every kernel source is compiled with nvcc for sm_90a into a shared
library with a plain C interface (no PyTorch headers), one library per
source, all sources started together, into ``build/repro_torch_kernels``
at the repository root.  A library's file name carries a hash of the
nvcc flags and of every file in the ``csrc`` directories (sources
include the shared headers of ``ccim_matmul/csrc``), so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
The kernel modules bind their entry points with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"

# library name -> source, relative to this package
SOURCES = {
    "skinny": "ccim_matmul/csrc/ccim_prepacked_skinny.cu",
    "general": "ccim_matmul/csrc/ccim_prepacked_general.cu",
    "unpacked": "ccim_matmul/csrc/ccim_unpacked.cu",
    "complex_skinny": "ccim_complex/csrc/ccim_complex_skinny.cu",
    "complex_general": "ccim_complex/csrc/ccim_complex_general.cu",
    "complex_unpacked": "ccim_complex/csrc/ccim_complex_unpacked.cu",
    "paged_attn": "paged_attn/csrc/paged_attn_decode.cu",
    "paged_attn_dh256": "paged_attn/csrc/paged_attn_dh256.cu",
    "int8": "int8_matmul/csrc/int8_w8a8.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def lib_path(name: str) -> Path:
    src = _KERNELS / SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_KERNELS.glob("*/csrc/*")):
        h.update(str(f.relative_to(_KERNELS)).encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library; returns them by
    name.  Sources missing from the build directory are compiled in
    parallel, one nvcc per source; a failed build raises with nvcc's
    output.  ``build_info`` records the seconds spent and ptxas's
    register/shared-memory report."""
    if len(_libs) == len(SOURCES):
        return _libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for name, src in SOURCES.items():
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_KERNELS / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        for _, tmp, _ in procs.values():
            tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    logs = {n: lib_path(n).with_suffix(".log") for n in SOURCES}
    build_info.update(seconds=time.time() - t0, built=sorted(procs),
                      ptxas={n: p.read_text() for n, p in logs.items()
                             if p.exists()})
    for name in SOURCES:
        _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every kernel at first use)."""
    return load_all()[name]


def bind(entries: Dict[str, tuple]) -> Dict[str, object]:
    """Entry points by library name, from ``{name: (symbol, argtypes)}``,
    each returning a CUDA error code (int); builds every kernel at first
    use."""
    libs = load_all()
    fns = {}
    for name, (symbol, argtypes) in entries.items():
        fn = getattr(libs[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns
