"""Builds the port's CUDA sources with `nvcc` and its C++ with `g++`.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/recommenders_tpu_torch/lib<name>-<digest>.so` under the
checkout's root, where `<digest>` hashes the source, every shared header
`csrc/*.cuh` (which any source may include) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. K1 and K2
(training) and the probe's copy step (`copy_chain`) load through ctypes
(`library`).

K3, K4 and K5 (serving) are dispatcher ops: `csrc/torch_ops.cpp`
registers them (`TORCH_LIBRARY(recommenders_tpu_torch, ...)`) and links
the `bucketed_scores` and `leaf_scoring` libraries. `torch_ops` compiles
it with `g++` against the installed wheel's headers and libraries (no
`torch/extension.h`, no libtorch_python, so a C++ host without Python can
load it too) into `libtorch_ops-<digest>.so` beside them, whose digest
also covers the two kernel libraries, the flags and the torch version,
and loads it with `torch.ops.load_library`. The pooled lookup is a
dispatcher op of a library of its own, `csrc/pooled_ops.cpp` linking
`pooled_lookup` (`pooled_ops`), built and loaded at its first call, so
a process that never pools loads nothing of it.

Every build runs at first use, never at import: machines without `nvcc`
still import every module. A build writes a temporary file and renames
it into place, so concurrent processes never load a half-written one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "recommenders_tpu_torch"

# Every CUDA source of the port, by name (`csrc/<name>.cu`).
SOURCES = ("bucketed_scores", "sparse_apply", "fused_retrieval",
           "leaf_scoring", "copy_chain", "pooled_lookup")

# The serving kernels' libraries, which the op library links.
SERVING_SOURCES = ("bucketed_scores", "leaf_scoring")
OPS_SOURCE = "torch_ops"
# The pooled lookup's op library and the kernel library it links.
POOL_SOURCES = ("pooled_lookup",)
POOL_OPS_SOURCE = "pooled_ops"

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


def torch_flags(cuda: bool) -> Tuple[list, list]:
    """(compile, link) `g++` flags for C++ built against the installed
    torch (its headers, libraries and C++ ABI); `cuda` adds the CUDA
    toolkit's headers and torch's CUDA libraries."""
    from torch.utils import cpp_extension

    device_type = "cuda" if cuda else "cpu"
    includes = cpp_extension.include_paths(device_type=device_type)
    libs = cpp_extension.library_paths(device_type=device_type)
    if cuda:
        includes.append(str(Path(_nvcc()).parents[1] / "include"))
    compile_flags = [
        "-std=c++20", "-O2", "-fPIC",
        f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
    ] + [f"-I{d}" for d in includes]
    link_flags = ([f"-L{d}" for d in libs] + [f"-Wl,-rpath,{d}" for d in libs]
                  + ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"])
    if cuda:
        link_flags += ["-ltorch_cuda", "-lc10_cuda"]
    return compile_flags, link_flags


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found; the port's C++ builds with it.")
    return gxx


def _run(cmd: list, what: str) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {what}:\n{proc.stdout}")
    return proc.stdout


def compile_cpp(source: Path, target: Path, flags: list) -> str:
    """Compiles and links `source` with `g++ flags` into `target` (through
    a temporary file) unless it exists; returns the compiler's output."""
    if target.exists():
        return ""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        out = _run([_gxx(), str(source), "-o", str(tmp), *flags],
                   source.name)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _op_library_path(source: str, kernels: Iterable[str]) -> Path:
    """Where the op library of `csrc/<source>.cpp` is built: its digest
    covers the source, the kernel libraries it links (so an edited
    kernel rebuilds it) and the torch it is built against."""
    h = hashlib.sha256((CSRC / f"{source}.cpp").read_bytes())
    for name in kernels:
        h.update(library_path(name).name.encode() + b"\0")
    h.update(f"{torch.__version__} {torch._C._GLIBCXX_USE_CXX11_ABI}".encode())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def torch_ops_path() -> Path:
    """Where the op library of `csrc/torch_ops.cpp` is built."""
    return _op_library_path(OPS_SOURCE, SERVING_SOURCES)


def pooled_ops_path() -> Path:
    """Where the op library of `csrc/pooled_ops.cpp` is built."""
    return _op_library_path(POOL_OPS_SOURCE, POOL_SOURCES)


def _build_op_library(source: str, kernels: Iterable[str],
                      sources: Iterable[str]) -> Dict[str, str]:
    """Builds the op library of `csrc/<source>.cpp` where it is not built
    yet: it compiles (g++, against torch's headers) while `sources` and
    the `kernels` it links build (nvcc), then links them. Returns the
    compilers' output by source, as `build` does."""
    kernels = tuple(kernels)
    target = _op_library_path(source, kernels)
    if target.exists():
        return build(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compile_flags, link_flags = torch_flags(cuda=True)
    obj = target.with_name(f"{target.name}.{os.getpid()}.o")
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cpp = CSRC / f"{source}.cpp"
    proc = subprocess.Popen(
        [_gxx(), "-c", str(cpp), "-o", str(obj), *compile_flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        logs = build(set(sources) | set(kernels))
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {cpp.name}:\n{out}")
        logs[source] = out + _run(
            [_gxx(), "-shared", str(obj), "-o", str(tmp), *link_flags,
             f"-L{BUILD_DIR}", "-Wl,-rpath,$ORIGIN",
             *(f"-l:{library_path(name).name}" for name in kernels)],
            f"{source}.so")
        os.replace(tmp, target)
        return logs
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)


def build_torch_ops(sources: Iterable[str] = SERVING_SOURCES
                    ) -> Dict[str, str]:
    """Builds the op library where it is not built yet: `torch_ops.cpp`
    compiles (g++, against torch's headers) while `sources` build (nvcc;
    the serving kernels' libraries at least), then links them. Returns
    the compilers' output by source, as `build` does."""
    return _build_op_library(OPS_SOURCE, SERVING_SOURCES, sources)


def build_pooled_ops() -> Dict[str, str]:
    """Builds the pooled lookup's op library where it is not built yet,
    as `build_torch_ops` builds the serving ops'."""
    return _build_op_library(POOL_OPS_SOURCE, POOL_SOURCES, POOL_SOURCES)


@functools.lru_cache(maxsize=None)
def torch_ops() -> Path:
    """Builds (if needed) and loads the op library; its ops are then
    `torch.ops.recommenders_tpu_torch.*`. Returns its path, which a C++
    host loads with `--ops`."""
    build_torch_ops()
    path = torch_ops_path()
    torch.ops.load_library(str(path))
    return path


# `op_launches` keys: op → its number in `csrc/torch_ops.cpp`.
OPS = {"bucketed_scores": 0, "probed_leaf_scores": 1,
       "probed_bucketed_scores": 2}
OP_FORMATS = ("f32", "bf16", "int8", "int4")


@functools.lru_cache(maxsize=None)
def _ops_counters() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(torch_ops()))
    lib.recommenders_tpu_torch_launches.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
    lib.recommenders_tpu_torch_launches.restype = ctypes.c_int64
    lib.recommenders_tpu_torch_reset_launches.restype = None
    return lib


def op_launches() -> Dict[str, Dict[str, int]]:
    """Launches counted inside the op libraries by op and format (every
    launch in this process, an AOTInductor package's included); the
    pooled lookup's under `pooled_lookup`, once its library is loaded."""
    lib = _ops_counters()
    out = {op: {fmt: int(lib.recommenders_tpu_torch_launches(i, j))
                for j, fmt in enumerate(OP_FORMATS)}
           for op, i in OPS.items()}
    if pooled_ops.cache_info().currsize:
        out["pooled_lookup"] = pool_launches()
    return out


def reset_op_launches() -> None:
    _ops_counters().recommenders_tpu_torch_reset_launches()
    if pooled_ops.cache_info().currsize:
        reset_pool_launches()


@functools.lru_cache(maxsize=None)
def pooled_ops() -> ctypes.CDLL:
    """Builds (if needed) and loads the pooled lookup's op library; its op
    is then `torch.ops.recommenders_tpu_torch.pooled_lookup`."""
    build_pooled_ops()
    path = pooled_ops_path()
    torch.ops.load_library(str(path))
    lib = ctypes.CDLL(str(path))
    lib.recommenders_tpu_torch_pool_launches.argtypes = [ctypes.c_int]
    lib.recommenders_tpu_torch_pool_launches.restype = ctypes.c_int64
    lib.recommenders_tpu_torch_reset_pool_launches.restype = None
    return lib


# The pooled lookup's table formats, in `csrc/pooled_ops.cpp`'s order.
POOL_FORMATS = ("f32", "f16")


def pool_launches() -> Dict[str, int]:
    """The pooled lookup's launches by table format, counted inside its
    library (which this loads, building it where needed)."""
    lib = pooled_ops()
    return {fmt: int(lib.recommenders_tpu_torch_pool_launches(i))
            for i, fmt in enumerate(POOL_FORMATS)}


def reset_pool_launches() -> None:
    pooled_ops().recommenders_tpu_torch_reset_pool_launches()


def k3_fold_counts(reset: bool = False) -> Dict[str, int]:
    """K3 int8's fast fold (`csrc/bucketed_scores.cu`, `fold_group_fast`)
    over every launch since the library loaded or the last reset: the
    chunks of 32 x 16 scores its compare-only pass checked, and those that
    took the update. Reading waits for the card, so it belongs at the end
    of a run, never inside a request; `reset` clears the counts after."""
    fn = _ops_counters().bucketed_scores_fold_counts
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    fn.restype = ctypes.c_int
    checked, updated = ctypes.c_longlong(), ctypes.c_longlong()
    err = fn(ctypes.byref(checked), ctypes.byref(updated), int(reset))
    if err != 0:
        raise RuntimeError(f"reading K3's fold counts failed (cudaError "
                           f"{err})")
    return {"checked": checked.value, "updated": updated.value}


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
