"""The port's single-process retrieval examples end to end on the CPU,
at a tiny size (one epoch), as `tests/test_torch_examples_e2e.py` runs
the ranking examples.
"""

import pytest

from torch_examples_common import run_main
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ['context_features', 'deep_recommenders', 'featurization', 'full_pipeline', 'sequential_retrieval'])
def test_example_main_on_the_cpu(name):
    run_main(name)
