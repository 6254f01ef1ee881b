"""Import boundary of the PyTorch/CUDA port, checked with ``ast``.

Every ``.py`` file under ``src/repro_torch/`` and ``chip_smoke.py`` must
import neither ``jax`` nor the JAX package ``repro`` (``repro_torch`` is
the port itself), and no ``try`` around a kernel launch may fall back to
a plain version in its ``except``.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def _names(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _falls_back(tree):
    """``try`` bodies that launch a kernel while an ``except`` calls a
    plain version (``*_torch``) or the CPU path."""
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        body = set().union(*(_names(s) for s in node.body))
        launches = any(n == "KERNEL" or n.endswith("_launch") for n in body)
        for handler in node.handlers:
            names = set().union(*(_names(s) for s in handler.body))
            if launches and any(n.endswith("_torch") or n == "cpu" for n in names):
                found.append(node.lineno)
    return found


def test_files_found():
    assert len(FILES) >= 20
    assert any(f.name == "chip_smoke.py" for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"
    assert not _falls_back(tree), f"{path} falls back from a kernel launch"


def test_checker_catches_violations():
    bad = ast.parse("import jax.numpy as jnp\nfrom repro.core import hdb\n"
                    "from repro_torch.core import u64\n")
    assert [m for m in _imported_modules(bad) if _forbidden(m)] == [
        "jax.numpy", "repro.core"]
    fallback = ast.parse("try:\n    KERNEL(x)\nexcept RuntimeError:\n"
                         "    y = tri_decode_torch(x)\n")
    assert _falls_back(fallback) == [1]
