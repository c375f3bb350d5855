"""Build and load the port's CUDA kernels.

Each library is compiled from its ``.cu`` source in ``csrc/`` by ``nvcc``
into a shared library with a plain C interface, at first use, and loaded
with ``ctypes``.  The output lands in ``build/gym_soccer_tpu_torch/`` at
the root of the checkout, named by a hash of its files (the source and the
headers it includes) and flags, so an edit to any of them is rebuilt and
an unchanged library is not.  Nothing is built or loaded when this module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gym_soccer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each library's files: the .cu sources it compiles and the headers they
# include, all of which key its build.
LIBRARIES = {"step_kernel": ("step_kernel.cu", "game.cuh", "pipeline.cuh"),
             "learner_kernel": ("learner_kernel.cu", "game.cuh",
                                "pipeline.cuh"),
             "iql_kernel": ("iql_kernel.cu", "game.cuh", "pipeline.cuh"),
             "altq_kernel": ("altq_kernel.cu", "game.cuh", "pipeline.cuh"),
             "parity_kernel": ("parity_kernel.cu",),
             "rmplus_kernel": ("rmplus_kernel.cu",),
             "threefry_kernel": ("threefry_kernel.cu", "threefry.cuh"),
             "engine_kernel": ("engine_kernel.cu", "game.cuh",
                               "threefry.cuh"),
             "mixed_alt_kernel": ("mixed_alt_kernel.cu", "game.cuh",
                                  "threefry.cuh"),
             "scatter_kernel": ("scatter_kernel.cu",)}

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin "
                       "and /usr/local/cuda/bin); the CUDA kernels cannot "
                       "be built")


def library_path(name: str) -> Path:
    """Where the library ``name`` is built, keyed on its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless a build of the same sources exists.
    The compiler's report (``-Xptxas -v``: registers, spills) is kept
    beside it as ``<library>.log``.  Raises RuntimeError if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out
    return compile_sources(
        [CSRC / s for s in LIBRARIES[name] if s.endswith(".cu")], out)


def compile_sources(sources, out: Path) -> Path:
    """Compile the ``.cu`` files ``sources`` into the library ``out`` with
    `NVCC_FLAGS`, its compiler report beside it as ``<library>.log``."""
    nvcc = find_nvcc()   # before the temporary file, which it would leave
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> dict[str, Path]:
    """Build every library, one nvcc process each, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; loaded once a process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
