"""Marker base class for tasks (port of `recommenders_tpu/tasks/base.py`)."""

import abc


class Task(abc.ABC):
    """Marker interface for recommender tasks.

    Tasks are plain callables mapping embeddings or predictions to a
    scalar loss (and outputs that metrics read). They hold no state.
    """
