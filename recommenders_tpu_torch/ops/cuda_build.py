"""Builds the port's CUDA sources with `nvcc` and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/recommenders_tpu_torch/lib<name>-<digest>.so` under the
checkout's root, where `<digest>` hashes the source, every shared header
`csrc/*.cuh` (which any source may include) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. The build runs at
first use, never at import: machines without `nvcc` still import every
module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "recommenders_tpu_torch"

# Every CUDA source of the port, by name (`csrc/<name>.cu`).
SOURCES = ("bucketed_scores", "sparse_apply", "fused_retrieval",
           "leaf_scoring")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels build only where the CUDA toolkit is."
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compiles every named source that is not built yet.

    One `nvcc` per source, all started together. Returns the compiler's
    output (including `-Xptxas -v`'s register and shared-memory report)
    for each source it compiled; raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    try:
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            running[name] = (proc, tmp, target)
        logs = {}
        for name, (proc, tmp, target) in running.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, target)
            logs[name] = out
        return logs
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu`, built if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a `c_void_p` argument (None → NULL)."""
    return None if t is None else t.data_ptr()


def raise_on(err: int, what: str, error_string) -> None:
    """Raises if a launcher returned a nonzero `cudaError_t`; its source's
    `error_string` names it."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {error_string(err).decode()} "
            f"(cudaError {err})"
        )
