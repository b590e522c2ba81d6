"""What the benchmark may import: never JAX or the JAX package (top-level names
compared whole, so the port `iggt_official_tpu_torch` passes and
`iggt_official_tpu` fails), never the JAX package's `benchmarks/` folder; the
plain reference nothing of the port either."""

from __future__ import annotations

import ast
import re

import pytest

from perfbench.tests.scaled import CHECKOUT

BENCH_DIR = CHECKOUT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "iggt_official_tpu", "benchmarks"}
SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def imported_tops(source: str):
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_top_level_names_compared_whole():
    assert imported_tops("import iggt_official_tpu_torch.ops") == {"iggt_official_tpu_torch"}
    assert imported_tops("from iggt_official_tpu.ops import x") & FORBIDDEN
    assert imported_tops("import jax.numpy as jnp") & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_and_no_benchmarks_folder(path):
    source = path.read_text()
    assert not imported_tops(source) & FORBIDDEN, path
    assert not re.search(r"[\"']benchmarks/", source), path


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path.read_text())
    assert "iggt_official_tpu_torch" not in tops
    assert not any(t.startswith("iggt") for t in tops)
    tree = ast.parse(path.read_text())
    froms = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.startswith("perfbench") and not m.startswith("perfbench.reference")
                   for m in froms)
