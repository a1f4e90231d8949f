"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` source is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, one ``nvcc``
process per source, all started together, and loaded with ctypes. The
libraries go to ``kernels/build/`` (listed in .gitignore) and are built
anew in every process: there is no cache of prebuilt binaries.

``--fmad=false`` keeps every a*b+c as two rounded operations, as the
plain torch versions compute them; ``-Xptxas -v`` reports registers and
spills, kept in ``build_log``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $PATH first, then $CUDA_HOME and /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_all() -> None:
    """Compile every source not built yet in this process, in parallel."""
    todo = [p for p in sorted(CSRC.glob("*.cu")) if p.stem not in _libs]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src in todo:
        out = BUILD_DIR / f"{src.stem}.{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(out), str(src)]
        procs.append((src, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, proc in procs:
        log, _ = proc.communicate()
        build_log[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        _libs[src.stem] = ctypes.CDLL(str(out))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _libs:
        build_all()
    return _libs[name]
