"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
library's file name carries a hash of its source, so an edited source is
rebuilt at its next use and an unchanged one is loaded as it is.  Builds
go to ``build/repro_torch/`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded library; name -> {"seconds": ..., "log": nvcc's stderr};
# (name, C function) -> the function with its argument types set
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, Dict] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: List[str]) -> None:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Raises with nvcc's output when a
    build fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, t0, p in procs:
        log, _ = p.communicate()
        BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, _target(n))   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def entry(name: str, fn: str, argtypes: Sequence) -> Callable[..., int]:
    """The C function ``fn`` of ``csrc/<name>.cu``'s library, its argument
    types set and its result an int, looked up once: a call then converts
    its arguments only."""
    f = _ENTRIES.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
        _ENTRIES[name, fn] = f
    return f
