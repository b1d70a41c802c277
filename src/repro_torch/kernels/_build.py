"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` have a plain C interface, so they compile
with nvcc alone, in seconds, without PyTorch's headers. At first CUDA
use ``library()`` compiles every ``.cu`` file to an object — one nvcc
per source, all started together — links them into one shared library
for ``sm_90a`` and loads it with ctypes. The library is keyed by a hash
of the sources and flags, so an edit rebuilds it and a stale build is
never loaded. It lives in ``_build/`` beside this file (listed in
``.gitignore``), inside the checkout.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from repro_torch.analysis.compile_guard import record

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-std=c++17", "-O3", ARCH, "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every exported function returns cudaGetLastError() as an int
SIGNATURES = {
    "svm_rbf_gram_block": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    "svm_rbf_gram_matvec": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                            _I, _I, _I, _I, _I, _I, _I, _P],
    "svm_rbf_gram_row": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "svm_rbf_gram_row_cached": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "svm_kkt_select": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                       _P],
    "svm_decision": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                     _P, _P, _P],
    "svm_multitask_decision": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "svm_rff_features": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I,
                         _P],
    "svm_dcd_epoch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    "svm_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "svm_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_F, _F] + [_I] * 7
                               + [_P],
    "svm_ssd_diag": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    "svm_ssd_diag_bwd": [_P] * 12 + [_I] * 7 + [_P],
    "svm_empty": [_P],
}

_lock = threading.Lock()
_lib: list = []          # the loaded library, once built
build_seconds: list = []  # wall time of the build this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "port's CUDA kernels are built with it at first use")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            (Path(tmp) / (src.stem + ".log")).write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        logs = "".join((Path(tmp) / (s.stem + ".log")).read_text()
                       for s in _sources())
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, ARCH, "-shared", *map(str, objs), "-o",
                               str(lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        out.with_suffix(".ptxas.log").write_text(logs)
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none


def ptxas_report(kernel: str) -> list[dict]:
    """Registers, static shared memory and spills of every compiled
    instantiation of the kernels whose mangled names hold ``kernel``, as
    ptxas reported them when the loaded library was built."""
    log = BUILD_DIR / f"libsvm_kernels_{_digest()}.ptxas.log"
    out, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)} if kernel in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _lock:
        if _lib:
            return _lib[0]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = BUILD_DIR / f"libsvm_kernels_{_digest()}.so"
        if not path.exists():
            t0 = time.perf_counter()
            _compile(path)
            build_seconds.append(time.perf_counter() - t0)
            record("kernel library build", path.name)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib.append(lib)
        return lib
