"""Marker base class for tasks (port of `recommenders_tpu/tasks/base.py`)."""

import abc
import dataclasses


class Task(abc.ABC):
    """Marker interface for recommender tasks.

    Tasks are plain callables mapping embeddings or predictions to a
    scalar loss (and outputs that metrics read). They hold no state.

    A task with a `mesh` field computes, on each rank of the mesh's
    data axis, this rank's share of the global batch's loss: the shares
    sum over the axis to the loss one device gives the global batch,
    and their gradients to its gradient. `models.Trainer(mesh=...)`
    hands its mesh to a model's tasks through `on_mesh`.
    """

    def on_mesh(self, mesh, data_axis: str):
        """This task over `data_axis` of `mesh` (None: on one device)."""
        return dataclasses.replace(self, mesh=mesh, data_axis=data_axis)
