"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "outdoor_nerf_depth_tpu"}


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "outdoor_nerf_depth_torch" not in set(_imported(path))


def test_the_port_name_is_not_mistaken_for_the_jax_package():
    assert "outdoor_nerf_depth_torch".split(".")[0] not in FORBIDDEN
