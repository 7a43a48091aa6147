"""The port's single-process ranking examples end to end on the CPU, at
a tiny size (one epoch, or 3 steps): each `main(..., device="cpu")` runs
through and returns the numbers its JAX example prints (or its
`results` / `history`), every one of them finite
(`torch_examples_common.CASES`). The retrieval examples run in
`tests/test_torch_examples_e2e_retrieval.py`, quickstart and
efficient_serving in `tests/test_torch_examples_serving.py`, the
distributed examples in `tests/test_torch_examples_distributed.py`.
"""

import pytest

from torch_examples_common import run_main
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", ['basic_ranking', 'deep_ranking_dcn', 'hybrid_dlrm', 'listwise_ranking', 'multitask', 'prebuilt_dlrm', 'unified_embedding'])
def test_example_main_on_the_cpu(name):
    run_main(name)
