"""The benchmark measures the PyTorch port alone: no module of it imports
JAX or the JAX package, the plain reference imports nothing of the
program, a run ends with neither loaded, and a run finds a card or fails."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench import spec as specs

FORBIDDEN = {"jax", "jaxlib", "flax", "spfx"}
SOURCES = sorted(glob.glob(os.path.join(specs.HERE, "**", "*.py"),
                           recursive=True))


def top_level_imports(path):
    """The top-level names (the part before the first dot, whole) that the
    module at ``path`` imports, anywhere in it."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, specs.HERE)
                              for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's; neither may stand for
    # the other
    assert "spfx_torch".split(".")[0] not in FORBIDDEN
    assert "spfx.chol".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    assert top_level_imports(os.path.join(specs.HERE, "reference.py")) <= {
        "__future__", "numpy", "scipy", "torch"}


def harness(code, env=None):
    e = dict(os.environ, **(env or {}))
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=specs.ROOT,
                          env=e, capture_output=True, text=True, timeout=300)


def test_a_run_ends_without_jax():
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import run\n"
        "rc = run.main(['--workload', 'poisson3d-48-chol-f32.refactor',\n"
        "               '--seed', '5', '--seconds', '0.3', '--trace', '0'],\n"
        "              device='cpu', patch={'grid': 5})\n"
        "print(json.dumps({'rc': rc, 'bad': run.forbidden_modules(),\n"
        "                  'torch': 'spfx_torch' in sys.modules}))\n")
    out = harness(code)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    result, end = json.loads(lines[-2]), json.loads(lines[-1])
    assert result["correct"] is True
    assert end == {"rc": 0, "bad": [], "torch": True}


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    import torch
    from portbench import run
    torch.set_num_threads(2)
    monkeypatch.setitem(sys.modules, "spfx", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "spfx.chol", sys.modules["json"])
    assert {"spfx", "spfx.chol"} <= set(run.forbidden_modules())
    rc = run.main(["--workload", "poisson3d-48-chol-f32.refactor", "--seed",
                   "6", "--seconds", "0.3", "--trace", "0"], device="cpu",
                  patch={"grid": 5})
    out = capsys.readouterr()
    assert rc != 0 and "{" not in out.out
    assert "loaded" in out.err and "spfx" in out.err


def test_a_run_without_a_card_fails():
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "poisson3d-48-chol-f32.refactor", "--seed", "3000000019",
         "--seconds", "1", "--trace", "0"], cwd=specs.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr
