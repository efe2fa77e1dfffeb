"""Build and load the port's CUDA kernels (no reference counterpart: the
reference's Pallas kernels are traced by JAX at run time).

Every ``*/csrc/*.cu`` under ``repro_torch/kernels`` is compiled by
``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, which is loaded with ``ctypes``. Each source compiles in its
own ``nvcc`` process, all started together, and one more ``nvcc`` call
links the objects. The library lands under ``build/`` at the repository
root, named by a hash of the sources and flags: a changed source
rebuilds, an unchanged one loads at once. The build happens at first
use; nothing outside the repository's sources is needed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> list:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, ``$PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin); "
        "the port's CUDA kernels are built on a host with the CUDA toolkit")


def _key(srcs) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    headers = sorted(KERNELS_DIR.glob("*/csrc/*.cuh"))
    for p in list(srcs) + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"repro_torch_kernels_{_key(sources())}.so"


def build() -> tuple:
    """Compile the library if it is missing.

    Returns ``(path, seconds, log)``: the compiler's output (with the
    ``-Xptxas -v`` register and shared-memory lines) and the build time,
    or ``(path, 0.0, "")`` when the library was already built. Raises
    ``RuntimeError`` with the log when a compile or the link fails.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp_"))
    try:
        objs, procs = [], []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = tmp / "lib.so"
        link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs),
                               "-o", str(lib)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib, out)  # atomic: concurrent builds agree on the file
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, time.perf_counter() - t0, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    path, _, _ = build()
    return ctypes.CDLL(str(path))
