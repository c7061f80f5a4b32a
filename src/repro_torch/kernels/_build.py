"""Build and load the port's CUDA kernels: ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` compiles at first use into ``build/`` beside
this file (listed in ``.gitignore``), under a name keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source never loads a stale library.  Nothing is built when the
package is imported.  :func:`build_all` compiles several sources at
once, one ``nvcc`` process each.

A build variant is an argument, ``defines``: preprocessor names passed
as ``-D`` flags (``CHECKED``: every shared-memory and global index of
the SSD kernels asserted in bounds, ``csrc/tf32_mma.cuh``; ``RAGGED``:
the SSD backward's ragged heads instance at every shape, which the card
tests hold bit-equal to the constant-bound instances and
``chip_smoke.py --zamba2-study`` times against them).  They enter the
flags, so the hash, and the library's name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the bounds-checked build of the SSD kernels
CHECKED = ("LRK_CHECKED",)
# the SSD backward with its ragged heads instance at every shape
RAGGED = ("LRK_RAGGED_ONLY",)

_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of repro_torch build only where the CUDA toolkit is "
        "installed")


def flags(defines=()) -> tuple:
    """``NVCC_FLAGS`` and a ``-D`` flag per name of ``defines``."""
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags(defines)).encode())
    variant = "".join(f".{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{variant}.{h.hexdigest()[:16]}.so"


def build(name: str, force: bool = False, defines=()) -> dict:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``);
    returns the library path, the build seconds and the compiler's report
    (``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises on a failed build."""
    out = library_path(name, defines)
    if out.exists() and not force:
        return {"path": out, "seconds": 0.0, "log": "(cached)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}")
    # atomic rename: a concurrent process never loads a half-written file
    os.replace(tmp, out)
    return {"path": out, "seconds": secs, "log": res.stdout + res.stderr}


def build_all(names, force: bool = False, checked=()) -> dict:
    """Compile several sources in parallel (one ``nvcc`` each, all
    started together), and the :data:`CHECKED` build of each name in
    ``checked``; ``{name: build report}`` as :func:`build` gives it, the
    checked builds under ``"<name>.checked"``.  Raises on the first
    failed build."""
    from concurrent.futures import ThreadPoolExecutor
    jobs = [(n, n, ()) for n in names] + [
        (f"{n}.checked", n, CHECKED) for n in checked]
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        futures = {key: pool.submit(build, n, force, d)
                   for key, n, d in jobs}
        return {key: f.result() for key, f in futures.items()}


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``defines``),
    built on first use."""
    path = library_path(name, defines)
    lib = _LOADED.get(path)
    if lib is None:
        build(name, defines=defines)
        lib = ctypes.CDLL(str(path))
        _LOADED[path] = lib
    return lib
