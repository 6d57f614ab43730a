"""Guards of the PyTorch/CUDA port (bigdl_tpu_torch).

* The port, ``chip_smoke.py``, ``k1_variants.py``, ``k9_variants.py``,
  ``f32_steps.py``, ``sass_diff.py``, ``bwd_rows.py``,
  ``k4_strided_variants.py``, ``lm_update_probe.py`` and the rank
  processes of the data-parallel tests (``tests/_torch_distri_child.py``,
  ``tests/_torch_fsdp_child.py``)
  import neither jax/jaxlib nor anything of the JAX package.  The scan is static (an AST walk of the sources): the
  interpreter that runs the tests may already hold jax, so an
  import-time check could not tell.
* The default device is the GPU: with no CUDA device an entry point
  raises instead of running on the CPU; only ``device="cpu"`` runs
  there.
"""
import ast
from pathlib import Path

import pytest
import torch

from bigdl_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "bigdl_tpu")


def _port_sources():
    files = sorted((REPO / "bigdl_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "k1_variants.py",
                    REPO / "k9_variants.py", REPO / "f32_steps.py",
                    REPO / "sass_diff.py", REPO / "bwd_rows.py",
                    REPO / "k4_strided_variants.py",
                    REPO / "lm_update_probe.py",
                    REPO / "tests" / "_torch_distri_child.py",
                    REPO / "tests" / "_torch_fsdp_child.py"]


def forbidden_imports(source: str):
    """(line, module) of every import of a forbidden top-level package:
    ``import``/``from`` statements (relative imports stay inside the
    port) and ``importlib.import_module``/``__import__`` of a literal."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if called in ("import_module", "__import__"):
                names = [node.args[0].value]
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


def test_port_sources_import_no_jax_and_no_jax_package():
    files = _port_sources()
    assert len(files) > 20, "the scan found too few port sources"
    bad = {str(f.relative_to(REPO)): hits for f in files
           if (hits := forbidden_imports(f.read_text()))}
    assert bad == {}


@pytest.mark.parametrize("module", [
    "optim/regularizer.py", "optim/optax_bridge.py", "optim/optim_method.py",
    "optim/optimizer.py", "parallel/ring_attention.py", "nn/attention.py",
    "models/transformer.py", "utils/file_io.py", "dataset/dataset.py",
    "telemetry/__init__.py", "telemetry/perf.py", "telemetry/device_info.py",
    "telemetry/aggregate.py", "optim/profiling.py"])
def test_scan_covers_the_training_breadth_modules(module):
    """The modules of the training-breadth and telemetry slices are in
    the scan and import neither jax nor the JAX package (the bridge wraps
    ``torch.optim``, the fsspec backend imports ``fsspec`` only, the
    telemetry modules are their own copies of the jax-free ones)."""
    path = REPO / "bigdl_tpu_torch" / module
    assert path in _port_sources()
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("path", [
    "bigdl_tpu_torch/optim/distri_optimizer.py",
    "bigdl_tpu_torch/optim/_sharding_utils.py",
    "bigdl_tpu_torch/optim/evaluator.py", "bigdl_tpu_torch/optim/predictor.py",
    "bigdl_tpu_torch/parallel/all_reduce.py",
    "bigdl_tpu_torch/parallel/broadcast.py", "bigdl_tpu_torch/utils/engine.py",
    "tests/_torch_distri_child.py", "lm_update_probe.py"])
def test_scan_covers_the_data_parallel_modules(path):
    """The data-parallel slice's modules, the rank processes of its
    tests and the F6 probe are in the scan and import neither jax nor
    the JAX package."""
    assert REPO / path in _port_sources()
    assert forbidden_imports((REPO / path).read_text()) == []


@pytest.mark.parametrize("module", [
    "serving/fleet.py", "serving/router.py", "serving/registry.py",
    "serving/health.py", "serving/autoscale.py",
    "serving/request_trace.py", "serving/trace_report.py",
    "serving/server.py", "serving/pools.py", "loop/__init__.py",
    "loop/continuous.py", "resilience/elastic.py",
    "serving/__init__.py", "resilience/faults.py"])
def test_scan_covers_the_serving_fleet_modules(module):
    """The serving-fleet slice's modules (copies of the JAX package's
    jax-free ones, with their own imports) are in the scan and import
    neither jax nor the JAX package."""
    path = REPO / "bigdl_tpu_torch" / module
    assert path in _port_sources()
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize("snippet", [
    "import jax",
    "import jax.numpy as jnp",
    "from jaxlib import xla_client",
    "from bigdl_tpu.serving import status",
    "import bigdl_tpu.nn",
    "def f():\n    from jax import lax\n",
    "import importlib\nimportlib.import_module('jax.numpy')",
    "__import__('bigdl_tpu')",
])
def test_scan_catches_each_import_form(snippet):
    assert forbidden_imports(snippet)


@pytest.mark.parametrize("snippet", [
    "import bigdl_tpu_torch",
    "from bigdl_tpu_torch.ops import layer_norm",
    "from .ops import flash_attention",
    "from ..device import resolve_device",
    "import torch\nimport numpy as np",
])
def test_scan_allows_the_port_and_torch(snippet):
    assert forbidden_imports(snippet) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda")])
def test_explicit_cuda_without_cuda_raises(no_cuda, device):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(device)


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda):
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import LayerNorm

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(16, embed_dim=8, num_heads=2, num_layers=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(16, embed_dim=8, num_heads=2, num_layers=1, max_len=8,
                      seq_strategy="blocksparse",
                      blocksparse={"window": 2, "globals": 1, "block": 4})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LayerNorm(8, device="cuda")


@pytest.mark.parametrize("build", ["ResNet50", "ResNetCifar", "LeNet5",
                                   "SpatialConvolution",
                                   "SpatialBatchNormalization"])
def test_conv_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda, build):
    from bigdl_tpu_torch import models, nn

    make = {"ResNet50": lambda: models.ResNet50(10),
            "ResNetCifar": lambda: models.ResNetCifar(8),
            "LeNet5": models.LeNet5,
            "SpatialConvolution": lambda: nn.SpatialConvolution(3, 4, 3, 3),
            "SpatialBatchNormalization":
                lambda: nn.SpatialBatchNormalization(4)}[build]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_cpu_only_when_named(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
