"""The port stands alone: neither it nor ``chip_smoke.py`` imports JAX or
the JAX package, and its entry points run on the card unless asked for
the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import environment
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.dataset import DeviceCachedIterator
from deeplearning4j_tpu_torch.nn import ComputationGraph
from deeplearning4j_tpu_torch.zoo import GPT_TINY, ResNet50, build_gpt

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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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


def test_importing_the_attention_kernels_needs_neither_nvcc_nor_triton(
        tmp_path):
    """With no nvcc on the path and triton blocked, the attention module
    imports and its op runs on the CPU; nothing is built or loaded."""
    code = ("import sys\n"
            "sys.modules['triton'] = None\n"
            "import torch\n"
            "from deeplearning4j_tpu_torch.kernels import _cuda, attention\n"
            "q = torch.randn(1, 2, 5, 16, requires_grad=True)\n"
            "attention.scaled_dot_product_attention(q, q, q, causal=True)"
            ".sum().backward()\n"
            "print(len(_cuda._LIBS), len(_cuda.BUILDS), "
            "sum(attention.LAUNCHES.values()))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0", "0"]


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


def test_samediff_and_gpt_raise_without_a_card_unless_asked_for_cpu(
        no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SameDiff()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_gpt(GPT_TINY, batch=2, seq_len=8)
    ids = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCachedIterator([ids], [ids], batch_size=2)
    sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device="cpu")
    assert sd.device == torch.device("cpu")
    assert all(a.device.type == "cpu" for a in sd.trainable_params().values())
    assert SameDiff(device="cpu").device.type == "cpu"


def test_unknown_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        environment.default_device("meta")


def test_serving_monitor_and_memory_modules_are_in_the_checks():
    """The import checks above walk every module of the port: the serving
    tier, its host modules and the paged attention kernel among them."""
    files = {f.relative_to(PORT).as_posix() for f in PORT.rglob("*.py")}
    assert {"memory.py", "monitor/trace.py", "monitor/steptime.py",
            "monitor/memstats.py", "serving/generative.py",
            "serving/sampling.py", "serving/paged/server.py",
            "serving/paged/pool.py", "kernels/paged_attention.py",
            "serving/inference.py", "serving/batching.py",
            "serving/queue.py", "serving/resilience.py",
            "serving/metrics.py", "serving/loadgen.py"} <= files


def test_servers_raise_without_a_card_unless_asked_for_cpu(no_card):
    from deeplearning4j_tpu_torch.serving import (GenerativeServer,
                                                  greedy_decode)
    from deeplearning4j_tpu_torch.serving.paged import PagedGenerativeServer
    from deeplearning4j_tpu_torch.zoo import (gpt_generative_spec,
                                              gpt_paged_spec)
    sd = build_gpt(GPT_TINY, batch=2, seq_len=8, device="cpu")
    dense, paged = gpt_generative_spec(sd, GPT_TINY), gpt_paged_spec(
        sd, GPT_TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerativeServer(dense, warmup=False, start=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedGenerativeServer(paged, warmup=False, start=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_decode(dense, [1, 2], 2)
    srv = PagedGenerativeServer(paged, warmup=False, start=False,
                                device="cpu")
    assert srv._kc.device.type == "cpu"
    srv.shutdown()


def test_parallel_inference_serves_on_the_networks_device(no_card):
    """``ParallelInference`` takes no device: it serves where the network
    was built, and a network is built on the card unless asked for the
    CPU (which raises here, with no card)."""
    from deeplearning4j_tpu_torch.serving import (InferenceMode,
                                                  ParallelInference)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParallelInference(ResNet50(height=32, width=32,
                                   num_classes=4).build())
    net = ResNet50(height=32, width=32, num_classes=4).build(device="cpu")
    with ParallelInference(net, mode=InferenceMode.INPLACE) as pi:
        assert pi.device == torch.device("cpu")
        out = pi.output(np.zeros((2, 3, 32, 32), np.float32))
    assert out.shape == (2, 4) and np.all(np.isfinite(out))
