"""Nothing of the benchmark imports JAX or the JAX package, compared on
whole top-level names (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from benchmark import run
from conftest import BENCH

JAX_SIDE = {"jax", "jaxlib", "flax", "uda_clr_tpu"}


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    names = top_level_imports(path)
    assert "uda_clr_tpu_torch" not in names and "benchmark" not in names


def test_the_run_refuses_jax_side_modules_by_whole_name():
    mods = ["uda_clr_tpu_torch", "uda_clr_tpu_torch.train.steps", "jaxtyping", "flaxen",
            "torch"]
    assert run.loaded_forbidden(mods) == []
    assert run.loaded_forbidden(mods + ["jax.numpy", "uda_clr_tpu.ops", "flax"]) == \
        ["flax", "jax.numpy", "uda_clr_tpu.ops"]


def test_the_run_needs_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "clr-mbv2-staged", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err
