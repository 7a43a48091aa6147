"""The port stands alone: no file of `recommenders_tpu_torch/` nor
`chip_smoke.py` imports JAX, flax or the JAX package (not even its
modules that do not import JAX), nor `ml_dtypes` (bf16 goes through
torch; the machine with the card has no ml_dtypes). Checked statically,
on the parsed imports of every file."""

import ast
import re
from pathlib import Path

import pytest
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "recommenders_tpu",
             "ml_dtypes")
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
        "parallel/ann.py", "utils/collectives.py", "utils/export.py",
        "utils/native_serving.py", "ops/product_quantization.py",
        "examples/__init__.py", "tools/run_examples.py",
        "ops/copy_chain.py", "tools/alias_probe.py", "tools/build_api_docs.py",
    ):
        assert f"recommenders_tpu_torch/{module}" in names
    assert "chip_smoke.py" in names


def test_every_cuda_source_names_the_tpu_kernel_it_replaces():
    for source in sorted((ROOT / "recommenders_tpu_torch" / "csrc").glob(
            "*.cu")):
        text = source.read_text()
        assert "Replaces the TPU kernel" in text, source.name
        assert "What bounds it on the H100" in text, source.name


def test_every_jax_module_has_a_counterpart():
    """Listing both packages' modules shows no JAX module without one in
    the port."""
    jax_root = ROOT / "recommenders_tpu"
    port_root = ROOT / "recommenders_tpu_torch"
    missing = [p.relative_to(jax_root).as_posix()
               for p in sorted(jax_root.rglob("*.py"))
               if not (port_root / p.relative_to(jax_root)).is_file()]
    assert not missing, missing


# A repository tool whose counterpart in the port has another name.
TOOL_COUNTERPARTS = {"tools/reference_parity_ctr.py": "tools/quality_parity.py"}


@pytest.mark.parametrize(
    "jax_file",
    sorted((ROOT / "examples").glob("*.py")) + [
        ROOT / "tools" / name for name in (
            "run_examples.py", "build_api_docs.py",
            "reference_parity_ctr.py")],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_every_example_and_the_runner_have_a_counterpart(jax_file):
    """Each user example, the example runner, the API-docs tool and the
    CTR quality tool have a file in the port (`examples/` and `tools/`;
    of the same name, or the one `TOOL_COUNTERPARTS` names), which the
    import check above covers."""
    name = jax_file.relative_to(ROOT).as_posix()
    port = ROOT / "recommenders_tpu_torch" / TOOL_COUNTERPARTS.get(name, name)
    assert port.is_file(), port
    assert port in FILES


def _pallas_call_sites():
    """(file, line, names of the functions around it) of every
    `pl.pallas_call` in the JAX package and the benchmarks."""
    sites = []
    for path in sorted([*(ROOT / "recommenders_tpu").rglob("*.py"),
                        *(ROOT / "benchmarks").rglob("*.py")]):
        def walk(node, names):
            for child in ast.iter_child_nodes(node):
                inner = names
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    inner = names + [child.name]
                if (isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Attribute)
                        and child.func.attr == "pallas_call"):
                    sites.append((path.relative_to(ROOT).as_posix(),
                                  child.lineno, names))
                walk(child, inner)

        walk(ast.parse(path.read_text(), filename=str(path)), [])
    return sites


def test_every_pallas_call_is_replaced_by_a_cuda_source():
    """Every `pl.pallas_call` site is named by the "Replaces the TPU
    kernel" note of some `csrc/*.cu`: its file, its line (`:N`) and a
    function around it. A kernel added to the JAX tree without a port
    fails here."""
    notes = []
    for source in sorted((ROOT / "recommenders_tpu_torch" / "csrc").glob(
            "*.cu")):
        header = source.read_text().split("#include")[0]
        assert "Replaces the TPU kernel" in header, source.name
        notes.append(" ".join(header.replace("//", " ").split()))
    sites = _pallas_call_sites()
    assert len(sites) >= 8
    missing = [
        (path, line, names) for path, line, names in sites
        if not any(path in note and re.search(rf":{line}\b", note)
                   and any(name in note for name in names)
                   for note in notes)]
    assert not missing, missing


def test_the_serving_ops_library_includes_no_python_headers():
    """`csrc/torch_ops.cpp`, `csrc/pooled_ops.cpp` and
    `csrc/serving_host.cpp` build with g++ against libtorch alone: a C++
    host without Python loads them."""
    for name in ("torch_ops.cpp", "pooled_ops.cpp", "serving_host.cpp"):
        text = (ROOT / "recommenders_tpu_torch" / "csrc" / name).read_text()
        includes = [line for line in text.splitlines()
                    if line.startswith("#include")]
        assert includes, name
        assert not any("torch/extension.h" in line or "pybind" in line
                       or "Python.h" in line for line in includes), name
