"""No module of the benchmark imports JAX or the JAX package, and the
reference and the work arithmetic import nothing of the program. Names
are compared as whole top-level names: ``rayaccel_tpu_torch`` is not
``rayaccel_tpu``."""

from __future__ import annotations

import ast
import os

from rtbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "rayaccel_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in _sources(run.HERE):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_yardstick_takes_nothing_of_the_program():
    paths = [*_sources(os.path.join(run.HERE, "reference")),
             *_sources(os.path.join(run.HERE, "scenes")),
             os.path.join(run.HERE, "work.py"),
             os.path.join(run.HERE, "scene.py"),
             os.path.join(run.HERE, "stats.py")]
    for path in paths:
        assert "rayaccel_tpu_torch" not in set(_imports(path)), path


def test_whole_names_are_compared():
    assert "rayaccel_tpu_torch".split(".")[0] not in FORBIDDEN
