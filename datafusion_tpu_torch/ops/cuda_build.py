"""Build and load the port's hand-written CUDA kernels.

Each source under `datafusion_tpu_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, loaded with
`ctypes`. Libraries go to `build/datafusion_tpu_torch/` at the repository
root, named by a hash of the source and the flags, so a changed source is
rebuilt and an unchanged one is reused. Nothing is compiled when a module is
imported: the first launch builds, or a caller builds every source up front
with `build_all` (one `nvcc` process per source, all started together)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "datafusion_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH")
    return found


def library_path(source: str) -> Path:
    """Where the library built from csrc/<source> lives."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_all(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel, and
    return {source: library path}. The compiler's `-Xptxas -v` report
    (registers, shared memory, spills) is kept beside each library as .log."""
    paths = {s: library_path(s) for s in sources}
    procs = []
    for s, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures: List[str] = []
    for s, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {s} failed ({proc.returncode}):\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build_log(source: str) -> str:
    """The `-Xptxas -v` report of the library built from csrc/<source>."""
    return library_path(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built first if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = _LOADED[source] = ctypes.CDLL(str(build_all([source])[source]))
    return lib
