"""Build the port's native sources into shared libraries at first use.

Each source under ``arbius_tpu_torch/csrc/`` is compiled into a library
with a plain C interface and loaded with `ctypes`: a ``.cu`` source by
``nvcc`` for ``sm_90a`` (seconds to build; no PyTorch headers), a ``.cc``
source by ``g++``. A ``.cu`` source may include the headers
(``csrc/*.cuh``). The library lands in ``arbius_tpu_torch/build/``,
named by a hash of the source, the headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing here runs at import time,
and nothing falls back: a host without the compiler raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """`nvcc` from CUDA_HOME, /usr/local/cuda, or PATH; raises if absent."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def find_gxx() -> str:
    """`g++` from PATH; raises if absent."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found")
    return found


def _flags(source: str) -> tuple[str, ...]:
    return NVCC_FLAGS if source.endswith(".cu") else GXX_FLAGS


def library_path(source: str) -> Path:
    """Where the library for `source` (a file name under csrc/) goes."""
    headers = sorted(CSRC.glob("*.cuh")) if source.endswith(".cu") else []
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in
                                     [CSRC / source, *headers])
                            + " ".join(_flags(source)).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def compile_library(src: Path, so: Path) -> None:
    """Compile the source file `src` into the library `so` (nvcc for
    ``.cu``, with csrc/ on the include path, g++ otherwise). The
    compiler's report (for nvcc: ptxas registers, shared memory, spills)
    is kept beside it as ``.log``."""
    cuda = src.suffix == ".cu"
    compiler = find_nvcc() if cuda else find_gxx()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        [compiler, *_flags(src.name), *(("-I", str(CSRC)) if cuda else ()),
         "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=600)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed on {src.name}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, so)


def build(source: str) -> Path:
    """Compile csrc/`source` unless its library already exists."""
    so = library_path(source)
    if not so.exists():
        compile_library(CSRC / source, so)
    return so


def build_report(source: str) -> str:
    """The compiler's report for the current build of `source`."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str, declare) -> ctypes.CDLL:
    """Build (if needed) and load csrc/`source` once per process;
    `declare(lib)` sets argtypes/restype on the new handle."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _loaded[source] = lib
        return lib
