"""Build the CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is
compiled by ``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the root
of the checkout, keyed on a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, then
loaded with ``ctypes``. A build that already exists is reused; several
missing libraries compile in parallel, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("battery_episode", "battery_collect", "thermal_episode", "ev_episode",
           "lstm_episode", "neighborhood_episode", "neighborhood_postpass", "twin_q")
# -fmad=false: no multiply-add contraction, so each kernel rounds every
# operation as its plain PyTorch version does (IEEE division and square
# root are nvcc's defaults without --use_fast_math)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel. Returns the compiler's output (register and spill report
    included) for each library built by this call; raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {name: proc.communicate()[0] for name, (proc, _, _) in jobs.items()}
    for name, (proc, tmp, out) in jobs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{logs[name]}")
        os.replace(tmp, out)      # atomic: a concurrent process never loads half a file
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
