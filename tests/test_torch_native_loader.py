"""The port's native (C++) batcher: `tests/test_native_loader.py`'s cases
on `recommenders_tpu_torch.data.native_loader`, and the port's batches
against the JAX package's batcher (the same `native/loader.cc`) at one
thread, batch for batch (tolerance: none).

The library builds with `g++` into the port's build directory; a test
where the toolchain is missing fails at the build, it is not skipped.

The JAX batcher that the port is held against loads a library built for
this module alone (`jax_library`): `native/loader.cc` with the JAX
package's flags, into a private directory, under a temporary name and
then renamed. The JAX loader's own build writes `native/build/
libloader.so` in place, so a process that loads it while another is
writing it keeps the error for its whole life; no test here reads or
writes that file.
"""

import ctypes
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from recommenders_tpu.data import native_loader as jax_native_loader
from recommenders_tpu_torch import data as data_lib
from recommenders_tpu_torch import models as models_lib
from recommenders_tpu_torch.data import native_loader
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _data(n=1000, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "a": rng.randint(0, 100, size=n).astype(np.int32),
        "b": rng.normal(size=(n, 7)).astype(np.float32),
        "c": rng.randint(0, 2, size=(n, 3, 2)).astype(np.int64),
    }


def test_builds_into_the_ports_build_directory():
    assert native_loader.native_available()
    path = native_loader.library_path()
    assert path.is_file()
    assert path.parent == native_loader.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "recommenders_tpu_torch")
    assert path.name.startswith("libloader-") and path.suffix == ".so"


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Eight threads build into an empty directory at once: each gets a
    loadable library at the same path, and no temporary file is left."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native_loader._build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(paths)) == 1 and len(paths) == 8
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    ctypes.CDLL(str(paths[0])).loader_create  # loads and has the symbol


# The JAX package's flags (`recommenders_tpu/data/native_loader.py`).
JAX_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
JAX_BUILD_DIR = Path(jax_native_loader._SO).parent
PARITY_CASES = [(False, False, 64), (True, False, 64), (True, True, 100),
                (False, True, 1000)]


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """`native/loader.cc` built with the JAX package's flags into a
    directory of this module's own, atomically (the port's `_build`: a
    temporary name, then `os.replace`)."""
    assert native_loader.CXX_FLAGS == JAX_CXX_FLAGS
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(native_loader, "BUILD_DIR",
                      tmp_path_factory.mktemp("jax_loader"))
        path = native_loader._build()
    # The JAX loader rebuilds in place where its source is newer.
    assert os.path.getmtime(path) >= os.path.getmtime(jax_native_loader._SRC)
    return path


def _load_jax_batcher_from(patch, library):
    """Points the JAX loader at `library`, its cached load and error
    cleared; `patch` restores all three."""
    patch.setattr(jax_native_loader, "_SO", str(library))
    patch.setattr(jax_native_loader, "_lib", None)
    patch.setattr(jax_native_loader, "_build_error", None)


@pytest.fixture
def private_jax_loader(jax_library, monkeypatch):
    _load_jax_batcher_from(monkeypatch, jax_library)


def _assert_batches_equal_jax(shuffle, drop, batch):
    assert not Path(jax_native_loader._SO).is_relative_to(JAX_BUILD_DIR)
    data = _data(1000, seed=4)
    ours = native_loader.NativeBatcher(data, batch, shuffle=shuffle, seed=9,
                                       drop_remainder=drop, num_threads=1)
    theirs = jax_native_loader.NativeBatcher(
        data, batch, shuffle=shuffle, seed=9, drop_remainder=drop,
        num_threads=1)
    for _ in range(2):                        # two epochs
        got, want = list(ours()), list(theirs())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("shuffle,drop,batch", PARITY_CASES)
def test_single_thread_batches_equal_jax(private_jax_loader, shuffle, drop,
                                         batch):
    _assert_batches_equal_jax(shuffle, drop, batch)


def test_parity_holds_where_the_jax_loader_cached_a_truncated_library(
        jax_library, monkeypatch):
    """A worker that loaded `native/build/libloader.so` while another
    was writing it caches the loader's error for good; the parity cases
    load the private library all the same, bit-equal."""
    monkeypatch.setattr(jax_native_loader, "_lib", None)
    monkeypatch.setattr(jax_native_loader, "_build_error",
                        f"{jax_native_loader._SO}: file too short")
    with pytest.raises(RuntimeError, match="file too short"):
        jax_native_loader.NativeBatcher(_data(10), 4)
    with pytest.MonkeyPatch.context() as patch:
        _load_jax_batcher_from(patch, jax_library)
        for case in PARITY_CASES:
            _assert_batches_equal_jax(*case)
    assert jax_native_loader._build_error.endswith("file too short")
    # The port builds outside the JAX package's directory.
    assert not native_loader.BUILD_DIR.is_relative_to(JAX_BUILD_DIR)


def test_unshuffled_single_thread_matches_python():
    data = _data(257)
    batcher = native_loader.NativeBatcher(
        data, batch_size=64, shuffle=False, num_threads=1
    )
    batches = list(batcher())
    assert [b["a"].shape[0] for b in batches] == [64, 64, 64, 64, 1]
    for k in data:
        np.testing.assert_array_equal(
            np.concatenate([b[k] for b in batches]), data[k])


def test_multithreaded_covers_every_row_exactly_once():
    data = _data(10_000, seed=1)
    batcher = native_loader.NativeBatcher(
        data, batch_size=128, shuffle=True, seed=7, num_threads=4
    )
    seen = np.concatenate([b["a"] for b in batcher()])
    assert seen.shape[0] == 10_000
    np.testing.assert_array_equal(np.sort(seen), np.sort(data["a"]))


def test_rows_stay_aligned_across_columns():
    data = _data(5000, seed=2)
    data["b"] = np.repeat(data["a"].astype(np.float32)[:, None], 7, axis=1)
    batcher = native_loader.NativeBatcher(
        data, batch_size=256, shuffle=True, seed=3, num_threads=4
    )
    for batch in batcher():
        np.testing.assert_array_equal(
            batch["b"][:, 0].astype(np.int32), batch["a"])


def test_epochs_reshuffle():
    data = _data(512, seed=3)
    batcher = native_loader.NativeBatcher(
        data, batch_size=512, shuffle=True, seed=0, num_threads=1
    )
    e1 = next(iter(batcher()))["a"]
    e2 = next(iter(batcher()))["a"]
    assert not np.array_equal(e1, e2)
    np.testing.assert_array_equal(np.sort(e1), np.sort(e2))


def test_drop_remainder_and_close():
    batcher = native_loader.NativeBatcher(
        _data(130), batch_size=64, drop_remainder=True, num_threads=2
    )
    assert sorted(b["a"].shape[0] for b in batcher()) == [64, 64]
    batcher.close()
    batcher.close()                           # idempotent


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="leading dimension"):
        native_loader.NativeBatcher(
            {"a": np.zeros(10), "b": np.zeros(11)}, batch_size=4
        )
    with pytest.raises(ValueError, match="batch_size"):
        native_loader.NativeBatcher({"a": np.zeros(10)}, batch_size=0)


def test_batched_native_or_python_falls_back_when_the_build_fails(
        monkeypatch):
    data = _data(300)
    native = data_lib.batched_native_or_python(data, 64, shuffle=False)
    assert isinstance(native, native_loader.NativeBatcher)
    monkeypatch.setattr(native_loader, "_load_library", lambda: None)
    fallback = data_lib.batched_native_or_python(data, 64, shuffle=False)
    assert not isinstance(fallback, native_loader.NativeBatcher)
    # The native batcher's two producer threads may hand its batches out
    # in either order (`NativeBatcher`'s contract); each batch must be
    # one of the fallback's, whole.
    def in_order(batches):
        return sorted(batches, key=lambda batch: batch["b"].tobytes())

    got, want = in_order(native()), in_order(fallback())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_trains_a_model_end_to_end():
    ds = data_lib.synthetic_movielens(
        num_users=100, num_movies=150, num_interactions=8000, seed=4
    )
    gen = torch.Generator().manual_seed(0)
    model = models_lib.TwoTowerRetrieval(
        models_lib.EmbeddingTower(100, 16, device="cpu", generator=gen),
        models_lib.EmbeddingTower(150, 16, device="cpu", generator=gen),
        query_key="user_id", candidate_key="movie_id",
    )
    trainer = models_lib.Trainer(
        model, lambda p: torch.optim.Adagrad(p, lr=0.1,
                                             initial_accumulator_value=0.1))
    batcher = native_loader.NativeBatcher(
        ds.as_dict(), batch_size=256, shuffle=True, seed=5,
        drop_remainder=True,
    )
    state = trainer.init(gen, next(iter(batcher())))
    state, history = trainer.fit(state, batcher, epochs=2, verbose=False)
    losses = [e["loss"] for e in history["epochs"]]
    assert losses[-1] < losses[0]
