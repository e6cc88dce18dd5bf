"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one source under `csrc/` with a plain C interface. `nvcc`
compiles it for Hopper (`-gencode arch=compute_90a,code=sm_90a`) into a
shared library under the package's `build/` directory (git-ignored); the
library name carries a hash of the source and flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing is built at import:
`load()` builds on the first launch, and `build_all()` starts every nvcc
at once (one process per source) for callers that want the whole set up
front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC")
# Per-kernel extra flags. The BP decoder must reproduce its plain version's
# float sums exactly, so no multiply-add contraction there.
EXTRA_FLAGS = {
    "bp_decode": ("--fmad=false",),
    "esn_predict": (),
}

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _flags(name: str):
    return _COMMON_FLAGS + EXTRA_FLAGS.get(name, ())


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD / f"lib{name}-{h[:12]}.so"


def _nvcc_cmd(name: str, out: Path):
    return [nvcc_path(), *_flags(name), "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=tuple(EXTRA_FLAGS)) -> dict:
    """Compile every missing library in parallel; returns {name: seconds}
    spent building (0.0 where the library was already there)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, times = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    try:
        for name, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            times[name] = time.perf_counter() - t0
    finally:                      # a failed build leaves no nvcc running
        for p, tmp, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
