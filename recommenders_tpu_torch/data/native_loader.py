"""ctypes bindings for the native (C++) input pipeline.

Port of `recommenders_tpu/data/native_loader.py` over the repository's
`native/loader.cc`. `NativeBatcher` plays the role tf.data's C++ runtime
plays for the reference: shuffled batch assembly and prefetch run in C++
worker threads off the GIL, overlapping input preparation with the
training step. With one thread, its batches are the JAX package's batch
for batch (same source, same `std::mt19937_64` shuffle).

The shared library is compiled at first use, never at import, with
`g++ -O3 -shared -fPIC -std=c++17 -pthread` into
`build/recommenders_tpu_torch/libloader-<digest>.so` under the
checkout's root, where `<digest>` hashes the source and the flags; a
build goes to a temporary name and is renamed into place, so processes
building at once never load a half-written library.
`batched_native_or_python` falls back to the Python batcher when the
library cannot be built, as the JAX function does; `NativeBatcher`
itself raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "loader.cc"
BUILD_DIR = _ROOT / "build" / "recommenders_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libloader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    target = library_path()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(
            f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, target)
        finally:
            tmp.unlink(missing_ok=True)
    return target


def _load_library():
    """Builds (if needed) and loads the shared library; None on failure
    (the reason is kept for `NativeBatcher`'s error)."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except subprocess.CalledProcessError as e:
            _build_error = f"g++ failed: {e.stderr}"
            return None
        except OSError as e:
            _build_error = str(e)
            return None
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_add_column.restype = None
        lib.loader_add_column.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.loader_start.restype = None
        lib.loader_start.argtypes = [ctypes.c_void_p]
        lib.loader_next.restype = ctypes.c_int64
        lib.loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.loader_reset.restype = None
        lib.loader_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


class NativeBatcher:
    """Threaded native batcher over a dict of row-aligned NumPy arrays.

    Usage (same contract as `data.batched`: a zero-arg factory yielding
    dict batches, re-iterable per epoch):

    ```python
    batcher = NativeBatcher(train.as_dict(), batch_size=4096,
                            shuffle=True, seed=1)
    for batch in batcher():   # epoch 1
        ...
    for batch in batcher():   # epoch 2 (fresh shuffle)
        ...
    ```

    Batch order across threads is nondeterministic unless
    `num_threads == 1`; every row comes once an epoch either way.

    Args:
      data: Feature dict; all arrays share the leading row count. The
        batcher keeps C-contiguous copies for its lifetime.
      batch_size: Rows per batch.
      shuffle: Shuffle rows each epoch.
      seed: Base shuffle seed (the epoch index is added).
      drop_remainder: Drop the ragged final batch.
      num_threads: C++ producer threads.
      queue_capacity: Prefetch depth (batches).
    """

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        num_threads: int = 2,
        queue_capacity: int = 8,
    ) -> None:
        lib = _load_library()
        if lib is None:
            raise RuntimeError(
                f"native loader unavailable: {_build_error}"
            )
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self._lib = lib
        # C-contiguous copies; the loader keeps raw pointers into these.
        self._data = {
            k: np.ascontiguousarray(v) for k, v in data.items()
        }
        self._names = list(self._data.keys())
        rows = {v.shape[0] for v in self._data.values()}
        if len(rows) != 1:
            raise ValueError(
                f"All features must share the leading dimension; got "
                f"{ {k: v.shape for k, v in self._data.items()} }."
            )
        self._num_rows = rows.pop()
        self._epoch = 0
        self._handle = lib.loader_create(
            self._num_rows, batch_size, int(drop_remainder), int(shuffle),
            seed, num_threads, queue_capacity,
        )
        for name in self._names:
            arr = self._data[name]
            lib.loader_add_column(
                self._handle, arr.ctypes.data_as(ctypes.c_void_p),
                arr.dtype.itemsize * int(np.prod(arr.shape[1:],
                                                 dtype=np.int64)),
            )

    def __call__(self) -> Iterator[Dict[str, np.ndarray]]:
        lib = self._lib
        lib.loader_reset(self._handle, self._epoch)
        self._epoch += 1
        lib.loader_start(self._handle)
        ptrs = (ctypes.c_void_p * len(self._names))()
        while True:
            rows = lib.loader_next(self._handle, ptrs)
            if rows == 0:
                return
            batch = {}
            for c, name in enumerate(self._names):
                arr = self._data[name]
                shape = (rows,) + arr.shape[1:]
                count = int(np.prod(shape, dtype=np.int64))
                # Copy out: the loader reuses its buffer on the next call.
                flat = np.ctypeslib.as_array(
                    ctypes.cast(ptrs[c], ctypes.POINTER(
                        np.ctypeslib.as_ctypes_type(arr.dtype))),
                    shape=(count,),
                )
                batch[name] = flat.reshape(shape).copy()
            yield batch

    def close(self) -> None:
        """Stops the worker threads and frees the native loader."""
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.loader_destroy(handle)

    def __del__(self):
        self.close()


def batched_native_or_python(
    data: Dict[str, np.ndarray],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = True,
):
    """`NativeBatcher` when the toolchain is available, else
    `data.batched` (the JAX package's contract)."""
    if native_available():
        return NativeBatcher(
            data, batch_size, shuffle=shuffle, seed=seed,
            drop_remainder=drop_remainder,
        )
    from recommenders_tpu_torch.data import movielens

    return movielens.batched(
        data, batch_size, shuffle=shuffle, seed=seed,
        drop_remainder=drop_remainder,
    )
