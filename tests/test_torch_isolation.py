"""The PyTorch port stands alone: no module of ``dml_cnn_cifar10_tpu_torch``,
and not ``chip_smoke.py``, imports JAX, flax or the JAX package, and the
port imports with those made unimportable."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dml_cnn_cifar10_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "dml_cnn_cifar10_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_ast_scan_finds_no_forbidden_import():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, ROOT), mod) for p in files
           for mod in _imported_roots(p) if mod in FORBIDDEN]
    assert bad == []


def test_package_imports_with_jax_unimportable():
    """Every module of the port imports in a fresh interpreter where
    ``import jax`` (and flax, and the JAX package) raises; nothing is
    built or launched at import."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        f"for name in {FORBIDDEN!r}:",
        "    sys.modules[name] = None",
        "import dml_cnn_cifar10_tpu_torch as pkg",
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,",
        "                                               pkg.__name__ + '.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "from dml_cnn_cifar10_tpu_torch.ops import flash_attention, optimizer",
        "assert optimizer._LIB is None and flash_attention._LIB is None",
        "assert sum(optimizer.LAUNCHES.values()) == 0",
        "assert sum(flash_attention.LAUNCHES.values()) == 0",
        "print(len(names))",
    ])
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_chip_smoke_refuses_without_a_card():
    """On a host where torch sees no card the smoke exits non-zero and
    prints no result line."""
    pytest.importorskip("torch")
    code = ("import torch, runpy, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
