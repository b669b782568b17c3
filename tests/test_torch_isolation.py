"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless asked for the CPU."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import environment
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.zoo import ResNet50

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deeplearning4j_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_forbidden_prefix_check_tells_the_packages_apart():
    assert _forbidden("deeplearning4j_tpu.nn.graph")
    assert _forbidden("deeplearning4j_tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("deeplearning4j_tpu_torch.nn.graph")
    assert not _forbidden("jaxtyping")


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_port_imports_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys, importlib, importlib.util, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['deeplearning4j_tpu'] = None\n"
        "import deeplearning4j_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'deeplearning4j_tpu_torch.')]\n"
        "has_triton = importlib.util.find_spec('triton') is not None\n"
        "for n in names:\n"
        "    if n.endswith('_triton') and not has_triton:\n"
        "        continue\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 15


def test_importing_the_kernel_module_does_not_import_triton():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch.kernels.bn_relu\n"
            "import deeplearning4j_tpu_torch.zoo\n"
            "print('triton' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card_unless_asked_for_cpu(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        environment.default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        environment.default_device("cuda")
    conf = ResNet50(height=32, width=32, num_classes=4).conf()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(conf).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(height=32, width=32, num_classes=4).build()
    x = np.zeros((2, 3, 32, 32), np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1]]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCachedIterator(x, y, batch_size=2)
    assert environment.default_device("cpu") == torch.device("cpu")
    net = ComputationGraph(conf).init(device="cpu")
    assert all(p.device.type == "cpu" for p in net.model.parameters())
    it = DeviceCachedIterator(x, y, batch_size=2, device="cpu")
    assert it.Xs[0].device.type == "cpu" and it.Ys[0].device.type == "cpu"


def test_unknown_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        environment.default_device("meta")
