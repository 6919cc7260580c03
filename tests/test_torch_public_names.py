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


def test_the_walk_covers_the_training_extras_and_the_cluster_half():
    assert {f"{PORT}.earlystopping", f"{PORT}.earlystopping.trainer",
            f"{PORT}.earlystopping.saver", f"{PORT}.util.determinism",
            f"{PORT}.profiler", f"{PORT}.serving.kv_transfer",
            f"{PORT}.serving.prefix_directory"} <= set(MODULES)


@pytest.mark.parametrize("module,name,item", [
    ("serving", "ChaosProxy", "A11c"),
    ("serving.chaos", "SlowConsumerInjector", "A11c"),
    ("serving", "RemoteReplica", "A11c"),
    ("parallel", "ParallelWrapper", "A12"),
    ("parallel", "make_mesh", "A12"),
    ("parallel", "SequenceParallelWrapper", "A12b"),
    ("parallel", "PipelineParallelWrapper", "A12b"),
    ("parallel.multiprocess", "MultiProcessParallelWrapper", "A12c"),
    ("parallel.multiprocess", "initialize_multiprocess", "A12c"),
])
def test_unported_families_raise_naming_their_item(module, name, item):
    """The wire, the remote replicas and the network injectors (A11c),
    the data-parallel tier (A12, now A12a: the wrapper, the meshes), the
    in-process SPMD half (A12b: the pipeline and sequence wrappers) and
    the multi-process half (A12c: `multiprocess`) raised
    NotImplementedError naming their queue items until they were ported:
    now they resolve to the port's classes and functions."""
    mod = importlib.import_module(f"{PORT}.{module}" if module else PORT)
    if item in ("A11c", "A12", "A12b", "A12c"):
        obj = getattr(mod, name)
        assert inspect.isclass(obj) or inspect.isfunction(obj)
        exec(f"from {mod.__name__} import {name}", {})
        return
    with pytest.raises(NotImplementedError, match=rf"queue {item}\b"):
        getattr(mod, name)
    with pytest.raises(NotImplementedError, match=rf"queue {item}\b"):
        exec(f"from {mod.__name__} import {name}", {})


def test_the_walk_covers_the_replica_pool_tier():
    assert {f"{PORT}.serving.streaming", f"{PORT}.serving.exactly_once",
            f"{PORT}.serving.replica_pool", f"{PORT}.serving.autoscaler",
            f"{PORT}.serving.chaos"} <= set(MODULES)


A11B = ("Autoscaler", "DedupCache", "ExactlyOnceDoor", "ReplicaEvictedError",
        "ReplicaPool", "RequestJournal", "ResultPendingError",
        "StreamBackpressureError", "StreamRegistry", "TokenStream",
        "UnknownRequestError")
CHAOS_IN_PROCESS = (
    "BrokenModelInjector", "InjectedServingFault", "JournalCorruptionInjector",
    "KVTransferCorruptionInjector", "LoadSpikeInjector", "PrefixFetchSaboteur",
    "ReloadCorruptionInjector", "ReplicaCrashInjector", "ReplicaHangInjector",
    "SlowInferenceInjector", "TenantFloodInjector")


@pytest.mark.parametrize("name", A11B + CHAOS_IN_PROCESS)
def test_the_replica_pool_tier_resolves_from_serving(name):
    """The replica pool, the autoscaler, the streams, the exactly-once
    door and the in-process injectors are ported: `serving` exports the
    class its module defines, and the JAX package's `serving` has a
    name of the same kind."""
    serving = importlib.import_module(f"{PORT}.serving")
    ref = importlib.import_module(f"{REF}.serving")
    obj = getattr(serving, name)
    assert inspect.isclass(obj) and name in serving.__all__
    assert obj.__module__.startswith(f"{PORT}.serving.")
    assert inspect.isclass(getattr(ref, name))
    assert issubclass(obj, Exception) == issubclass(getattr(ref, name),
                                                    Exception)


def test_pretrain_and_sharded_experts_raise_naming_their_item():
    """Layerwise pretraining is ported (A9b): on a network without a
    pretraining layer it changes nothing; the expert-parallel MoE (A12b)
    is ported and routes a MoE layer's tokens one expert per slot."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.lenet import lenet_configuration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import experts

    net = MultiLayerNetwork(lenet_configuration(), device="cpu")
    before = net.params().clone()
    net.pretrain(DataSet(torch.zeros((2, 784)).numpy(), None))
    assert torch.equal(net.params(), before)
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    g = torch.Generator().manual_seed(0)
    p = {"router": torch.randn((4, 2), generator=g),
         "W1": torch.randn((2, 4, 8), generator=g),
         "b1": torch.zeros((2, 8)),
         "W2": torch.randn((2, 8, 4), generator=g),
         "b2": torch.zeros((2, 4))}
    tokens = torch.randn((8, 4), generator=g)
    mesh = make_mesh({"expert": 2}, devices=[torch.device("cpu")] * 2)
    y = experts.switch_ffn_sharded(p, tokens, mesh, axis_name="expert",
                                   data_axis=None, act=torch.relu,
                                   capacity_factor=4.0, aux_weight=0.01)
    ref = experts.switch_ffn(p, tokens, act=torch.relu,
                             capacity_factor=4.0, aux_weight=0.01)
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)


def test_the_walk_covers_the_wire_tier():
    assert {f"{PORT}.gateway", f"{PORT}.serving.remote_replica",
            f"{PORT}.serving.chaos", f"{PORT}.serving"} <= set(MODULES)


A11C = ("ChaosProxy", "ConnectionResetInjector", "GarbageResponseInjector",
        "NetworkLatencyInjector", "PartitionInjector", "RemoteReplica",
        "RemoteReplicaPool", "ReplicaEntryPoint", "ReplicaSpawnError",
        "ReplicaSupervisor", "SlowConsumerInjector", "SlowLorisInjector",
        "spawn_replica_pool")


@pytest.mark.parametrize("name", A11C)
def test_the_wire_tier_resolves_from_serving(name):
    """The cross-process pool and the network injectors are ported:
    `serving` exports the port's object of the JAX package's kind (a
    class, an exception, a function), defined in the port's modules."""
    serving = importlib.import_module(f"{PORT}.serving")
    ref = importlib.import_module(f"{REF}.serving")
    obj, robj = getattr(serving, name), getattr(ref, name)
    assert name in serving.__all__
    assert obj.__module__ in (f"{PORT}.serving.remote_replica",
                              f"{PORT}.serving.chaos")
    assert inspect.isclass(obj) == inspect.isclass(robj)
    if inspect.isclass(obj):
        assert issubclass(obj, Exception) == issubclass(robj, Exception)


def test_no_port_name_raises_naming_a11c():
    """No module of the port keeps a name that raises naming A11c."""
    for path in (REPO / PORT).rglob("*.py"):
        assert "queue A11c" not in path.read_text(), path


def test_the_walk_covers_the_fetchers_nlp_and_native():
    assert {f"{PORT}.datasets.fetchers", f"{PORT}.datasets.hdf5",
            f"{PORT}.native", f"{PORT}.native.loader", f"{PORT}.nlp",
            f"{PORT}.nlp.kernels", f"{PORT}.nlp.vocab",
            f"{PORT}.nlp.lookup_table", f"{PORT}.nlp.sequence_vectors",
            f"{PORT}.nlp.word2vec", f"{PORT}.nlp.paragraph_vectors",
            f"{PORT}.nlp.glove", f"{PORT}.nlp.serializer",
            f"{PORT}.nlp.bagofwords", f"{PORT}.nlp.tokenization",
            f"{PORT}.nlp.sentence_iterator", f"{PORT}.nlp.language",
            f"{PORT}.nlp.dictionary", f"{PORT}.nlp.uima"} <= set(MODULES)


def test_nlp_names_without_a_card_meaning_raise_naming_their_item():
    """`mesh=` over several distinct devices in one process is refused
    (the port runs one process per card; a mesh on one device trains
    like the single-device path); `require_partitionable_rng` is JAX
    PRNG plumbing (C3)."""
    from deeplearning4j_tpu_torch.nlp import SequenceVectors, kernels
    from deeplearning4j_tpu_torch.parallel import make_mesh

    two = make_mesh(devices=[torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="one process per card"):
        SequenceVectors(mesh=two, batch_size=64, device="cpu")
    one = make_mesh(devices=[torch.device("cpu")] * 2)
    assert SequenceVectors(mesh=one, batch_size=64, device="cpu").mesh is one
    with pytest.raises(NotImplementedError, match=r"queue C3\b"):
        kernels.require_partitionable_rng()


def test_the_walk_covers_graph_clustering_berkeley_and_the_ui():
    assert {f"{PORT}.graph", f"{PORT}.graph.graph", f"{PORT}.graph.walks",
            f"{PORT}.graph.deepwalk", f"{PORT}.graph.serializer",
            f"{PORT}.clustering", f"{PORT}.clustering.kmeans",
            f"{PORT}.clustering.tsne", f"{PORT}.clustering.kdtree",
            f"{PORT}.clustering.vptree", f"{PORT}.clustering.quadtree",
            f"{PORT}.clustering.sptree", f"{PORT}.util.berkeley",
            f"{PORT}.ui", f"{PORT}.ui.storage", f"{PORT}.ui.components",
            f"{PORT}.ui.stats_listener", f"{PORT}.ui.flow",
            f"{PORT}.ui.remote", f"{PORT}.ui.server"} <= set(MODULES)


def test_the_walk_covers_the_data_parallel_tier():
    assert {f"{PORT}.parallel.mesh", f"{PORT}.parallel.wrapper",
            f"{PORT}.parallel.device_prefetch", f"{PORT}.parallel.stats",
            f"{PORT}.parallel.time_source", f"{PORT}.parallel.repartition",
            f"{PORT}.parallel.training_master",
            f"{PORT}.parallel.parameter_server",
            f"{PORT}.parallel.multiprocess",
            f"{PORT}.parallel.fault_tolerance",
            f"{PORT}.parallel.early_stopping", f"{PORT}.parallel.export",
            f"{PORT}.parallel.main"} <= set(MODULES)


def test_the_walk_covers_the_spmd_half():
    assert {f"{PORT}.serving.tp_engine", f"{PORT}.parallel.pipeline",
            f"{PORT}.parallel.pipeline_wrapper", f"{PORT}.parallel.sequence",
            f"{PORT}.parallel.experts", f"{PORT}.ops.rng_rows"} \
        <= set(MODULES)


A12B = ("PipelineParallelWrapper", "SequenceParallelWrapper", "find_trunk",
        "pipeline_apply", "ring_attention", "shard_stacked_params",
        "stack_stage_params", "ulysses_attention")


@pytest.mark.parametrize("name", A12B)
def test_the_spmd_half_resolves_from_parallel(name):
    """The in-process SPMD half's names resolve from `parallel` to the
    port's own objects, of the JAX modules' kinds."""
    port = importlib.import_module(f"{PORT}.parallel")
    obj = getattr(port, name)
    mod = obj.__module__.rsplit(".", 1)[-1]
    robj = getattr(importlib.import_module(f"{REF}.parallel.{mod}"), name)
    assert obj.__module__.startswith(f"{PORT}.parallel.")
    assert inspect.isclass(obj) == inspect.isclass(robj)


A12A = ("DistributedComputationGraph", "DistributedMultiLayer",
        "EarlyStoppingDistributedTrainer", "EarlyStoppingParallelTrainer",
        "FaultInjectionListener", "FaultTolerantTrainer", "InjectedFault",
        "NaNGradientInjector", "NoHealthyWorkersError",
        "NonFiniteWorkerResultError", "ParallelWrapper",
        "ParameterAveragingTrainingMaster",
        "ParameterAveragingTrainingWorker", "ParameterServer",
        "ParameterServerParallelWrapper", "ParameterServerStallInjector",
        "ParameterServerTimeoutError", "PoisonBatchInjector", "Repartition",
        "RepartitionStrategy", "RetryingParameterServerClient",
        "SlowWorkerInjector", "TrainingHook", "TrainingMaster",
        "TrainingResult", "TrainingStats", "TrainingWorker",
        "WorkerCrashInjector", "WorkerFailureError", "WorkerHealth",
        "balanced_partitions", "current_worker_id", "make_mesh")


@pytest.mark.parametrize("name", A12A)
def test_the_data_parallel_tier_resolves_from_parallel(name):
    """Every name of the JAX package's `parallel` resolves in the port's
    to an object of the same kind, defined in the port's modules."""
    port = importlib.import_module(f"{PORT}.parallel")
    ref = importlib.import_module(f"{REF}.parallel")
    obj, robj = getattr(port, name), getattr(ref, name)
    assert obj.__module__.startswith(f"{PORT}.parallel.")
    assert inspect.isclass(obj) == inspect.isclass(robj)
    if inspect.isclass(obj):
        assert issubclass(obj, Exception) == issubclass(robj, Exception)


def test_no_port_name_raises_naming_a12_alone():
    """Every message of the port that named queue A12 names one of its
    parts; A12a, A12b and A12c are ported, and no message names A12b or
    A12c any more."""
    import re as _re

    for path in (REPO / PORT).rglob("*.py"):
        text = path.read_text()
        assert not _re.search(r"queue A12(?![abc])", text), path
        assert not _re.search(r"queue A12b\b", text), path
        assert not _re.search(r"queue A12c\b", text), path


def test_the_walk_covers_the_multiprocess_half_and_data_interop():
    assert {f"{PORT}.parallel.multiprocess", f"{PORT}.util.sharded_checkpoint",
            f"{PORT}.util.stablehlo_export", f"{PORT}.datavec",
            f"{PORT}.datavec.records", f"{PORT}.datavec.iterators",
            f"{PORT}.cloud", f"{PORT}.cloud.storage",
            f"{PORT}.cloud.provision", f"{PORT}.streaming",
            f"{PORT}.streaming.pipeline", f"{PORT}.streaming.embedded_kafka",
            f"{PORT}.modelimport", f"{PORT}.modelimport.keras"} \
        <= set(MODULES)


A12C_A14 = [("parallel.multiprocess", n) for n in (
    "MultiProcessParallelWrapper", "MultiProcessTrainingMaster",
    "global_mesh", "initialize_multiprocess")] + [
    ("util.sharded_checkpoint", "save_sharded_checkpoint"),
    ("util.sharded_checkpoint", "restore_sharded_checkpoint"),
    ("util.stablehlo_export", "export_inference"),
    ("util.stablehlo_export", "load_inference"),
    ("datavec", "SequenceRecordReaderDataSetIterator"),
    ("datavec", "AlignmentMode"), ("cloud", "GCSStorage"),
    ("cloud", "StorageDataSetIterator"), ("cloud", "TpuPodSpec"),
    ("cloud.provision", "ClusterSetup"), ("cloud.storage", "RetryingStorage"),
    ("streaming", "StreamingTrainPipeline"), ("streaming", "ServeRoute"),
    ("streaming.embedded_kafka", "EmbeddedKafkaBroker"),
    ("modelimport", "KerasModelImport"),
    ("modelimport", "UnsupportedKerasConfigurationException")]


@pytest.mark.parametrize("module,name", A12C_A14)
def test_the_multiprocess_half_and_data_interop_resolve(module, name):
    """A12c and A14 are ported: each name is the port's own object, of
    the JAX package's kind."""
    port = importlib.import_module(f"{PORT}.{module}")
    ref = importlib.import_module(f"{REF}.{module}")
    obj, robj = getattr(port, name), getattr(ref, name)
    assert obj.__module__.startswith(f"{PORT}.")
    assert inspect.isclass(obj) == inspect.isclass(robj)
    if inspect.isclass(obj):
        assert issubclass(obj, Exception) == issubclass(robj, Exception)


def test_no_port_name_raises_naming_a14_or_a12c():
    """No module of the port keeps a name that refuses naming A14 or
    A12c."""
    for path in (REPO / PORT).rglob("*.py"):
        text = path.read_text()
        assert "queue A14" not in text and "queue A12c" not in text, path
