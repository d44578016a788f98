"""The benchmark stands apart: nothing under perfbench/ imports JAX or the
JAX package, and the reference and the model families' widths import
nothing of the program, directly or through a module of the benchmark they
import. Names are compared whole, by their top-level part."""

import ast
from pathlib import Path

import pytest

from perfbench.run import forbidden_modules

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "sequoia_tpu"}


def _imports(path: Path):
    """(top-level name, level, module) of each import of a file."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            top = mod.split(".")[0] if node.level == 0 else None
            yield top, node.level, mod
            for a in node.names:   # `from .. import gen`, `from perfbench import gen`
                yield top, node.level, f"{mod}.{a.name}".strip(".")


def _files():
    files = sorted(HERE.rglob("*.py"))
    assert HERE / "run.py" in files and HERE / "reference" / "llama.py" in files
    assert HERE / "families" / "llama.py" in files and HERE / "program" / "llama.py" in files
    return files


def test_no_jax_anywhere():
    bad = [(str(p), top) for p in _files() for top, _, _ in _imports(p) if top in FORBIDDEN]
    assert not bad, bad


def _resolve(path: Path, level: int, mod: str):
    base = path.parent
    for _ in range(level - 1):
        base = base.parent
    target = base.joinpath(*mod.split(".")) if mod else base
    for cand in (target.with_suffix(".py"), target / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _reaches_program(path: Path, seen) -> list:
    if path in seen:
        return []
    seen.add(path)
    bad = []
    for top, level, mod in _imports(path):
        if top in ("sequoia_torch", *FORBIDDEN):
            bad.append((str(path), mod))
        if top == "perfbench":
            dep = _resolve(HERE / "x.py", 1, mod.split(".", 1)[1] if "." in mod else "")
        elif level:
            dep = _resolve(path, level, mod)
        else:
            dep = None
        if dep is not None:
            bad += _reaches_program(dep, seen)
    return bad


@pytest.mark.parametrize("folder", ["reference", "families"])
def test_reference_imports_nothing_of_the_program(folder):
    """The plain references, and the families' widths and work counts."""
    seen = set()
    bad = []
    for p in sorted((HERE / folder).rglob("*.py")):
        bad += _reaches_program(p, seen)
    assert not bad, bad
    if folder == "reference":
        assert HERE / "gen.py" in seen   # it does read the benchmark's weights
        assert HERE / "families" / "llama.py" in seen


def test_the_check_follows_imports_into_the_program(tmp_path):
    """`from perfbench import <module>` is followed, and a module that
    reaches the program through it is caught."""
    assert _reaches_program(HERE / "program" / "llama.py", set())
    f = tmp_path / "x.py"
    f.write_text("from perfbench import drive\n")
    assert (str(HERE / "drive.py"), "sequoia_torch.engine.batched") in _reaches_program(f, set())


def test_whole_names_not_prefixes():
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "sequoia_tpu.core"]) == \
        ["flax", "jax", "jaxlib", "sequoia_tpu"]
    assert forbidden_modules(["sequoia_torch", "sequoia_tpu_x", "jaxtyping", "numpy"]) == []
