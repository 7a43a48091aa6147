"""Checkpoint / resume on `torch.save`.

Port of `recommenders_tpu/utils/checkpoint.py` (orbax there; orbax is
JAX's). A checkpoint is a directory holding one `state.pt`, written by
`torch.save` of plain tensors, numbers, strings and dicts, and read with
`torch.load(weights_only=True)`, so loading one runs no pickled code. A
save writes a temporary directory and renames it into place when the
file is complete, so an interrupted save never becomes a checkpoint.

What a state saves:
  - `models.TrainState`: the step, the parameters, the optimizer's
    `state_dict`, the metric and loss states, and the state of its
    step generator;
  - `models.HybridState`: the parameters, the optimizer's `state_dict`,
    the pending engine update, and the engine state in the engine's
    logical layout (`EmbeddingEngine.logical_state`, the form
    `utils.convert` carries to and from JAX), so a stacked engine's
    checkpoint restores into an unstacked engine and the other way round;
  - an `EngineState` alone, logical in the same way;
  - any other nest of dicts, lists and tuples of tensors, NumPy arrays
    and numbers.
An engine state (alone or in a `HybridState`) needs its `engine` to save
and to restore.

`restore(path, template)` puts every tensor on the template's device and
dtype, so a checkpoint written on the card restores on the CPU and the
other way round (the counterpart of "CPU-built and TPU-built checkpoints
interchange", `recommenders_tpu/utils/checkpoint.py:10-12`). A
`TrainState`'s or `HybridState`'s parameters are the model's own
tensors, so they are restored in place, and its optimizer loads the
saved `state_dict`; everything else comes back as new tensors in the
returned state. A generator's state restores only into a generator on
the same kind of device (a CUDA generator's state is not a CPU one's);
across kinds the template's generator is kept.

Usage:

```python
mgr = CheckpointManager(directory, max_to_keep=3)
mgr.save(step, state)                     # synchronous
state = mgr.restore(template=state)       # latest, placed like template
state = mgr.restore(template=state, step=100)
```
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save", "restore"]

STATE_FILE = "state.pt"
# Stands in for a callable (a learning-rate schedule in an optimizer's
# param groups), which a weights-only file cannot hold; restore takes
# the template's value there.
_CALLABLE = "<callable: kept from the restore template>"


def _to_host(tree: Any) -> Any:
    """`tree` with every tensor (and NumPy array) as a CPU tensor that
    owns its storage."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if callable(tree):
        return _CALLABLE
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _like(saved: Any, template: Any, where: str = "state") -> Any:
    """`saved` with each tensor on its template tensor's device and
    dtype; entries and shapes must match the template's."""
    if isinstance(template, torch.Tensor):
        if (not isinstance(saved, torch.Tensor)
                or saved.shape != template.shape):
            raise ValueError(
                f"{where}: the checkpoint holds "
                f"{getattr(saved, 'shape', type(saved).__name__)}, the "
                f"template {tuple(template.shape)}")
        return saved.to(template.device, template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(saved.numpy(), dtype=template.dtype)
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"{where}: the checkpoint's entries differ "
                             f"from the template's "
                             f"{sorted(map(str, template))}")
        return {k: _like(saved[k], template[k], f"{where}[{k!r}]")
                for k in template}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"{where}: {len(saved)} entries, the template "
                             f"has {len(template)}")
        return type(template)(_like(s, t, f"{where}[{i}]")
                              for i, (s, t) in enumerate(zip(saved,
                                                             template)))
    return saved


def _generator_state(generator: Optional[torch.Generator]):
    if generator is None:
        return None
    return {"device": generator.device.type, "state": generator.get_state()}


def _kind(state: Any) -> str:
    """The state's kind: its class's name for the three states the
    module knows, "tree" for anything else. (Imported here: the models
    import `utils`.)"""
    from recommenders_tpu_torch.embedding import engine as engine_lib
    from recommenders_tpu_torch.models import base as models_base
    from recommenders_tpu_torch.models import hybrid as hybrid_lib

    for cls in (models_base.TrainState, hybrid_lib.HybridState,
                engine_lib.EngineState):
        if isinstance(state, cls):
            return cls.__name__
    return "tree"


def _engine_state(engine, state) -> dict:
    if engine is None:
        raise ValueError("An EngineState needs its `engine` to be saved "
                         "in the logical layout.")
    return _to_host(engine.logical_state(state))


def _payload(state: Any, engine) -> dict:
    kind = _kind(state)
    if kind == "TrainState":
        return {
            "kind": "TrainState",
            "step": state.step,
            "params": _to_host(state.params),
            "opt_state": _to_host(state.opt_state.state_dict()),
            "metric_states": _to_host(state.metric_states),
            "loss_states": _to_host(state.loss_states),
            "generator": _generator_state(state.generator),
        }
    if kind == "HybridState":
        return {
            "kind": "HybridState",
            "params": _to_host(state.params),
            "opt_state": _to_host(state.opt_state.state_dict()),
            "engine_state": _engine_state(engine, state.engine_state),
            "pending": _to_host(state.pending),
        }
    if kind == "EngineState":
        return {"kind": "EngineState",
                "engine_state": _engine_state(engine, state)}
    return {"kind": "tree", "tree": _to_host(state)}


@torch.no_grad()
def _load_params(params: dict, saved: dict) -> None:
    for name, value in _like(saved, params, "params").items():
        params[name].copy_(value)


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    optimizer.load_state_dict(_fill_callables(saved,
                                              optimizer.state_dict()))


def _fill_callables(saved: Any, current: Any) -> Any:
    """`saved` with each callable marker replaced by `current`'s value."""
    if isinstance(saved, str) and saved == _CALLABLE:
        return current
    if isinstance(saved, dict) and isinstance(current, dict):
        return {k: _fill_callables(v, current.get(k)) for k, v in
                saved.items()}
    if isinstance(saved, (list, tuple)) and isinstance(current,
                                                       (list, tuple)):
        return type(saved)(_fill_callables(s, c)
                           for s, c in zip(saved, current))
    return saved


def _restore_engine(engine, saved: dict):
    if engine is None:
        raise ValueError("Restoring an EngineState needs its `engine`.")
    return engine.state_from_logical(saved)


def _restore(saved: dict, template: Any, engine) -> Any:
    kind, want = saved["kind"], _kind(template)
    if kind != want:
        raise ValueError(f"The checkpoint holds a {kind}, the template is "
                         f"a {want}.")
    if kind == "TrainState":
        _load_params(template.params, saved["params"])
        _load_optimizer(template.opt_state, saved["opt_state"])
        generator = template.generator
        if (generator is not None and saved["generator"] is not None
                and saved["generator"]["device"] == generator.device.type):
            generator.set_state(saved["generator"]["state"])
        return dataclasses.replace(
            template, step=int(saved["step"]),
            metric_states=_like(saved["metric_states"],
                                template.metric_states, "metric_states"),
            loss_states=_like(saved["loss_states"], template.loss_states,
                              "loss_states"),
        )
    if kind == "HybridState":
        engine_state = _restore_engine(engine, saved["engine_state"])
        _load_params(template.params, saved["params"])
        _load_optimizer(template.opt_state, saved["opt_state"])
        # The pending update's ids and grads live where the engine does.
        return dataclasses.replace(
            template, engine_state=engine_state,
            pending=_on(saved["pending"], engine.device))
    if kind == "EngineState":
        return _restore_engine(engine, saved["engine_state"])
    return _like(saved["tree"], template)


def _on(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, device) for v in tree)
    return tree


def _meshed(engine) -> bool:
    return engine is not None and getattr(engine, "mesh", None) is not None


def save(path: str, state: Any, engine=None) -> None:
    """Saves `state` to the directory `path` (replacing what is there).

    `engine` is the `EmbeddingEngine` of an `EngineState` or
    `HybridState`; other states need none. A meshed engine's state is
    gathered into its logical layout on every rank (a collective), rank
    0 writes it, and every rank returns once it is written; `restore`
    then gives each rank its own shard."""
    path = Path(path).absolute()
    payload = _payload(state, engine)
    if _meshed(engine):
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(path, payload)
        dist.barrier()
        return
    _write(path, payload)


def _write(path: Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    tmp = path.with_name(f"{path.name}.tmp-{tag}")
    try:
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        if path.exists():
            old = path.with_name(f"{path.name}.old-{tag}")
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def restore(path: str, template: Any, engine=None) -> Any:
    """Restores the checkpoint at `path`, placed and typed like
    `template` (see the module docstring); a meshed engine keeps this
    rank's shard of the logical state."""
    file = Path(path).absolute() / STATE_FILE
    if not file.is_file():
        raise FileNotFoundError(f"No checkpoint at {file.parent}.")
    saved = torch.load(file, map_location="cpu", weights_only=True)
    return _restore(saved, template, engine)


class CheckpointManager:
    """Rolling checkpoint directory with retention and resume.

    The counterpart of orbax's `CheckpointManager` as the JAX package
    uses it (itself covering the reference's `tf.train.
    CheckpointManager`): numbered step checkpoints `<directory>/<step>`,
    `max_to_keep` retention, latest-step lookup.

    Args:
      directory: Checkpoint root directory (created if missing).
      max_to_keep: Retained checkpoints; older ones are deleted (None
        keeps all).
      save_interval_steps: If set, `save` is a no-op except at steps
        that are multiples of it (orbax's `should_save` policy).
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: Optional[int] = 3,
        save_interval_steps: Optional[int] = None,
    ) -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps or 1

    def save(self, step: int, state: Any, engine=None) -> bool:
        """Saves `state` under `step`; returns whether a save happened."""
        if step % self.save_interval_steps != 0:
            return False
        save(str(self.directory / str(step)), state, engine)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        return True

    def restore(self, template: Any, step: Optional[int] = None,
                engine=None) -> Any:
        """Restores the given (or latest) step, placed like `template`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"No checkpoints found under {self.directory}."
            )
        return restore(str(self.directory / str(step)), template, engine)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """Steps whose checkpoint is complete, in increasing order."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).is_file())

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX API."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
