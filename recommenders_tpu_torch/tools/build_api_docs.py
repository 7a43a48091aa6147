#!/usr/bin/env python3
"""API documentation of the PyTorch port: module docstrings → markdown.

The port's counterpart of `tools/build_api_docs.py`. Walks the port's
public modules (`MODULES`: the counterpart of every module the JAX tool
documents, then the wrappers of the port's hand-written CUDA kernels)
and, for every public class or function each defines, renders its
signature and docstring (and those of a class's public methods that
have one) into one markdown page per module, plus `index.md`. Its
default output, `docs/api_torch/`, is a directory of its own:
`docs/api/` holds the JAX package's pages.

    python3 -m recommenders_tpu_torch.tools.build_api_docs [--out DIR]

Imports only the port (on any machine: no module builds or loads a
kernel when it is imported).
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import re
import sys
from pathlib import Path
from typing import List, Optional

REPO = Path(__file__).resolve().parents[2]
PACKAGE = "recommenders_tpu_torch"
DEFAULT_OUT = REPO / "docs" / "api_torch"

MODULES = [
    f"{PACKAGE}.{name}" for name in (
        # The counterparts of the JAX tool's modules, in its order.
        "tasks.retrieval",
        "tasks.ranking",
        "tasks.listwise",
        "layers.factorized_top_k",
        "layers.approximate",
        "layers.loss",
        "layers.blocks",
        "layers.sequential",
        "layers.feature_interaction.dcn",
        "layers.feature_interaction.dot_interaction",
        "metrics.base",
        "metrics.factorized_top_k",
        "embedding.config",
        "embedding.embedding",
        "embedding.engine",
        "embedding.partial",
        "embedding.unified",
        "embedding.sparse_optimizer",
        "models.base",
        "models.retrieval",
        "models.ranking",
        "models.multitask",
        "models.hybrid",
        "optimizers.clippy_adagrad",
        "optimizers.composite",
        "parallel.mesh",
        "parallel.corpus",
        "parallel.retrieval_step",
        "ops.topk",
        "ops.scoring",
        "data.movielens",
        "data.vocab",
        "data.preprocessing",
        "data.native_loader",
        "utils.checkpoint",
        "utils.export",
        "utils.profiling",
        # The wrappers of the port's other CUDA kernels.
        "ops.sparse_apply",
        "ops.fused_retrieval",
        "ops.leaf_scoring",
        "ops.copy_chain",
        "ops.pooled_lookup",
    )
]


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Default values whose repr holds a memory address would change the
    # pages on every run.
    sig = re.sub(r"<([\w.]+) object at 0x[0-9a-f]+>", r"<\1>", sig)
    return re.sub(r"<function ([\w.<>]+) at 0x[0-9a-f]+>", r"<\1>", sig)


def public_members(module) -> list:
    """(name, object) of each public class or function `module` defines
    itself, in definition order."""
    return [(name, obj) for name, obj in vars(module).items()
            if not name.startswith("_")
            and (inspect.isclass(obj) or inspect.isfunction(obj))
            and getattr(obj, "__module__", None) == module.__name__]


def heading(name: str, obj) -> str:
    kind = "class" if inspect.isclass(obj) else "def"
    return f"## `{kind} {name}{_signature(obj)}`"


def render_module(module_name: str) -> str:
    module = importlib.import_module(module_name)
    lines = [f"# `{module_name}`", ""]
    if module.__doc__:
        lines += [inspect.cleandoc(module.__doc__), ""]
    for name, obj in public_members(module):
        lines += [heading(name, obj), ""]
        if obj.__doc__:
            lines += [inspect.cleandoc(obj.__doc__), ""]
        if inspect.isclass(obj):
            for mname, meth in vars(obj).items():
                if (mname.startswith("_") or not inspect.isfunction(meth)
                        or not meth.__doc__):
                    continue
                lines += [f"### `{name}.{mname}{_signature(meth)}`", "",
                          inspect.cleandoc(meth.__doc__), ""]
    return "\n".join(lines) + "\n"


def page_name(module_name: str) -> str:
    return module_name.removeprefix(f"{PACKAGE}.").replace(".", "_") + ".md"


def write(out: Path, modules: List[str] = MODULES) -> List[Path]:
    """Writes a page per module and `index.md` into `out`; returns the
    files written."""
    out.mkdir(parents=True, exist_ok=True)
    written = []
    index = ["# API reference: recommenders_tpu_torch", ""]
    for module_name in modules:
        path = out / page_name(module_name)
        path.write_text(render_module(module_name))
        written.append(path)
        index.append(f"- [`{module_name}`]({path.name})")
    (out / "index.md").write_text("\n".join(index) + "\n")
    return written + [out / "index.md"]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    written = write(args.out)
    print(f"wrote {len(written)} files to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
