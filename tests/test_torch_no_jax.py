"""The port stands alone: no file of `recommenders_tpu_torch/` nor
`chip_smoke.py` imports JAX, flax or the JAX package (not even its
modules that do not import JAX). Checked statically, on the parsed
imports of every file."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "recommenders_tpu")
FILES = sorted((ROOT / "recommenders_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_package_file_is_checked():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in (
        "ops/topk.py", "ops/quantization.py", "ops/scoring.py",
        "utils/activations.py", "layers/blocks.py",
        "layers/factorized_top_k.py", "models/retrieval.py",
        "utils/convert.py", "embedding/config.py", "embedding/embedding.py",
        "embedding/engine.py", "embedding/sparse_optimizer.py",
        "ops/sparse_apply.py", "ops/fused_retrieval.py", "layers/loss.py",
        "tasks/base.py", "tasks/retrieval.py", "ops/leaf_scoring.py",
        "layers/approximate.py", "layers/sequential.py", "metrics/base.py",
        "metrics/factorized_top_k.py", "models/base.py", "types.py",
        "utils/profiling.py", "tasks/ranking.py", "tasks/listwise.py",
        "layers/feature_interaction/__init__.py",
        "layers/feature_interaction/dcn.py",
        "layers/feature_interaction/dot_interaction.py",
        "embedding/partial.py", "models/ranking.py", "models/multitask.py",
        "models/hybrid.py", "optimizers/__init__.py",
        "optimizers/clippy_adagrad.py", "optimizers/composite.py",
        "ops/hashing.py", "embedding/unified.py", "data/__init__.py",
        "data/vocab.py", "data/preprocessing.py", "data/movielens.py",
        "data/native_loader.py", "utils/checkpoint.py",
        "tools/quality_parity.py", "parallel/__init__.py",
        "parallel/mesh.py", "parallel/launch.py", "parallel/corpus.py",
        "parallel/embedding_lookup.py", "parallel/retrieval_step.py",
        "parallel/ann.py", "utils/collectives.py",
    ):
        assert f"recommenders_tpu_torch/{module}" in names
    assert "chip_smoke.py" in names


def test_every_cuda_source_names_the_tpu_kernel_it_replaces():
    for source in sorted((ROOT / "recommenders_tpu_torch" / "csrc").glob(
            "*.cu")):
        text = source.read_text()
        assert "Replaces the TPU kernel" in text, source.name
        assert "What bounds it on the H100" in text, source.name
