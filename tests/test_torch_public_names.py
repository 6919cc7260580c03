"""Every public name of the JAX package resolves in the port, module by
module, or raises `NotImplementedError` naming the ROADMAP queue item
that will port it (ground rule 9): never `AttributeError` or
`ImportError`. The walk covers each module of the port that has a
counterpart in the JAX package, the package `__init__` files included.

A module's public names are its `__all__` when it has one, else the
classes and functions it defines and its UPPER_CASE constants (for a
package `__init__`: the classes and functions it exports from the JAX
package)."""
import importlib
import inspect
import re
import types
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
PORT = "deeplearning4j_tpu_torch"
REF = "deeplearning4j_tpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores, so that
    every small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module_names():
    """The port's modules that have a JAX-package counterpart, by file:
    the same list in every worker, whatever it imports."""
    out = []
    for path in sorted((REPO / PORT).rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        ref = REPO / REF / Path(*parts[1:])
        if ref.with_suffix(".py").exists() or (ref / "__init__.py").exists():
            out.append(".".join(parts))
    return out


def _public_names(ref_mod, is_pkg: bool):
    if hasattr(ref_mod, "__all__"):
        return list(ref_mod.__all__)
    names = []
    for name, obj in vars(ref_mod).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            owner = getattr(obj, "__module__", "") or ""
            if is_pkg and not owner.startswith(REF):
                continue
            if not is_pkg and owner != ref_mod.__name__:
                continue
        elif not re.fullmatch(r"[A-Z][A-Z0-9_]*", name):
            continue
        names.append(name)
    return names


MODULES = _module_names()


def test_the_walk_covers_the_serving_tier():
    assert {f"{PORT}.serving", f"{PORT}.serving.model_server",
            f"{PORT}.serving.observability", f"{PORT}.serving.decode_engine",
            f"{PORT}.ops", PORT} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_reference_names_resolve_or_name_a_queue_item(module):
    port_mod = importlib.import_module(module)
    ref_mod = importlib.import_module(REF + module[len(PORT):])
    is_pkg = hasattr(ref_mod, "__path__")
    wrong = []
    for name in _public_names(ref_mod, is_pkg):
        try:
            getattr(port_mod, name)
        except NotImplementedError as e:
            if not re.search(r"queue [ABC]\d+", str(e)):
                wrong.append(f"{name}: NotImplementedError naming no "
                             f"queue item ({e})")
        except Exception as e:  # the failure this test exists to catch
            wrong.append(f"{name}: {type(e).__name__}: {e}")
    assert not wrong, wrong


def test_the_walk_covers_the_cnn_and_moe_modules():
    assert {f"{PORT}.util.conv_utils", f"{PORT}.nn.conf.preprocessors",
            f"{PORT}.models.lenet", f"{PORT}.models", f"{PORT}.ops.aux_loss",
            f"{PORT}.parallel", f"{PORT}.parallel.experts"} <= set(MODULES)


def test_the_walk_covers_the_graph_and_pretraining_modules():
    assert {f"{PORT}.nn.graph", f"{PORT}.nn.graph.computation_graph",
            f"{PORT}.nn.conf.computation_graph_configuration",
            f"{PORT}.nn.conf.variational", f"{PORT}.models.resnet",
            f"{PORT}.util.time_series", f"{PORT}.gradientcheck"} \
        <= set(MODULES)


@pytest.mark.parametrize("module,name,item", [
    ("", "earlystopping", "A10b"),
    ("", "profiler", "A10b"),
    ("util", "determinism", "A10b"),
    ("parallel", "ParallelWrapper", "A12"),
    ("parallel", "make_mesh", "A12"),
])
def test_unported_families_raise_naming_their_item(module, name, item):
    """Early stopping, the determinism check and the profiler (A10b) and
    parallel training (A12) raise NotImplementedError naming their queue
    item, never AttributeError or ImportError."""
    mod = importlib.import_module(f"{PORT}.{module}" if module else PORT)
    with pytest.raises(NotImplementedError, match=rf"queue {item}\b"):
        getattr(mod, name)
    with pytest.raises(NotImplementedError, match=rf"queue {item}\b"):
        exec(f"from {mod.__name__} import {name}", {})


def test_pretrain_and_sharded_experts_raise_naming_their_item():
    """Layerwise pretraining is ported (A9b): on a network without a
    pretraining layer it changes nothing; the expert-parallel MoE still
    raises naming A12."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.lenet import lenet_configuration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import experts

    net = MultiLayerNetwork(lenet_configuration(), device="cpu")
    before = net.params().clone()
    net.pretrain(DataSet(torch.zeros((2, 784)).numpy(), None))
    assert torch.equal(net.params(), before)
    with pytest.raises(NotImplementedError, match=r"queue A12\b"):
        experts.switch_ffn_sharded(None, None, None)
