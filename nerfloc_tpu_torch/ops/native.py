"""Build and load the port's hand-written CUDA kernels and host helpers.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xptxas -v` into
`nerfloc_tpu_torch/_build/` (listed in .gitignore), under a file name keyed
on a hash of the source, then loaded with ctypes. ptxas's report
(registers, spills, shared memory of each kernel) is kept beside the
library and read by `build_report`. Nothing is compiled when a module is
imported. No fast-math flags: the fused aggregation
evaluates sin/cos of arguments up to 2^9 * offset, which needs the
accurate libdevice paths.

A host helper `csrc/<name>.cpp` (plain C interface too) is compiled the
same way with the host's C++ compiler (`$CXX`, else `g++` or `c++`: nvcc's
own host compiler on a CUDA machine) by `build_host`/`load_host`, without
FMA contraction.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no FMA contraction: each float operation of a host helper is one IEEE
# single operation (the TSDF host copy is bit-equal to its kernel)
HOST_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def find_cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found ($CXX, g++, c++)")


def _library_path(src: Path, flags: List[str]) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def library_path(name: str) -> Path:
    return _library_path(CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def _compile(compiler: str, flags: List[str], src: Path, report_suffix: str) -> Path:
    """Compile `src` unless a library for this exact source exists. Writes
    to a temporary name and renames, so concurrent builds never load a
    half-written file."""
    out = _library_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(compiler)} failed for {src.name}:\n"
                           f"{proc.stderr}")
    out.with_suffix(report_suffix).write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile csrc/<name>.cu with nvcc (see _compile)."""
    return _compile(find_nvcc(), NVCC_FLAGS, CSRC_DIR / f"{name}.cu", ".ptxas.txt")


def build_host(name: str) -> Path:
    """Compile the host helper csrc/<name>.cpp (see _compile)."""
    return _compile(find_cxx(), HOST_FLAGS, CSRC_DIR / f"{name}.cpp", ".cxx.txt")


def build_report(name: str) -> str:
    """ptxas's report for the built csrc/<name>.cu (building it if needed)."""
    return build(name).with_suffix(".ptxas.txt").read_text()


def build_all(names: Iterable[str]) -> List[Path]:
    """Build several sources at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def _load(key: str, builder) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(builder()))
            _loaded[key] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    return _load(name + ".cu", lambda: build(name))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cpp, building it if needed."""
    return _load(name + ".cpp", lambda: build_host(name))
