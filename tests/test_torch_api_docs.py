"""`recommenders_tpu_torch/tools/build_api_docs.py`: the port's API pages.

Every public class and function of every listed module gets a heading in
its module's page; the list covers the port's counterpart of every module
the JAX package's `tools/build_api_docs.py` documents; the tool writes
into a directory of its own, never `docs/api/`, the JAX package's pages.
"""

import importlib
import importlib.util
from pathlib import Path

import pytest

from recommenders_tpu_torch.tools import build_api_docs as docs
from torch_threads import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("api_torch")
    return out, docs.write(out)


def _jax_modules():
    spec = importlib.util.spec_from_file_location(
        "jax_build_api_docs", ROOT / "tools" / "build_api_docs.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.MODULES


def test_every_jax_module_has_its_counterpart_in_the_list():
    jax_modules = _jax_modules()
    assert len(jax_modules) >= 37
    for name in jax_modules:
        port = name.replace("recommenders_tpu.", "recommenders_tpu_torch.",
                            1)
        assert port in docs.MODULES, port
    assert len(set(docs.MODULES)) == len(docs.MODULES)
    assert all(m.startswith("recommenders_tpu_torch.") for m in docs.MODULES)


def test_every_public_name_gets_a_heading(written):
    out, files = written
    assert {p.name for p in files} == {
        docs.page_name(m) for m in docs.MODULES} | {"index.md"}
    index = (out / "index.md").read_text()
    for module_name in docs.MODULES:
        page = (out / docs.page_name(module_name)).read_text()
        assert page.startswith(f"# `{module_name}`")
        assert f"({docs.page_name(module_name)})" in index
        members = docs.public_members(importlib.import_module(module_name))
        for name, obj in members:
            assert docs.heading(name, obj) in page, (module_name, name)
    kernel_page = (out / "ops_copy_chain.md").read_text()
    assert "## `def copy_step(" in kernel_page
    assert "## `def copy_step_reference(" in kernel_page


def test_it_writes_its_own_directory(written):
    out, files = written
    assert docs.DEFAULT_OUT == ROOT / "docs" / "api_torch"
    assert docs.DEFAULT_OUT != ROOT / "docs" / "api"
    assert all(path.parent == out for path in files)
