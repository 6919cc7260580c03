"""Build the port's CUDA sources (`deeplearning4j_tpu_torch/csrc/*.cu`)
into shared libraries with a plain C interface, and load them with
ctypes.

A library is built at first use, from the sources in the checkout only,
with `nvcc -gencode arch=compute_90a,code=sm_90a`, into
`deeplearning4j_tpu_torch/_build/` (listed in `.gitignore`). Its file
name carries a digest of the source and the flags, so an edited source
is rebuilt and an unchanged one is not. `build` starts one nvcc per
source, all at once, and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


@dataclass
class BuildResult:
    path: Path
    log: str  # nvcc's output (ptxas registers/shared memory/spills); "" if cached


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of deeplearning4j_tpu_torch are built at first use")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Build every named source that is not built yet, one nvcc process
    each, all started together. Raises with nvcc's output if any fails."""
    results: Dict[str, BuildResult] = {}
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = BuildResult(out, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees old or new
        results[name] = BuildResult(out, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return results


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name].path))
            _loaded[name] = lib
        return lib
