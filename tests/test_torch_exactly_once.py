"""The port's exactly-once door (`serving.exactly_once`) held against the
JAX package on the CPU: the `DedupCache` verdict ladder (execute,
pending, cached, abandon, TTL and capacity bounds, the typed claim
ladder) gives the same verdicts, outcomes, errors and stats in both; a
`RequestJournal` written by either package is byte-identical to the
other's on the same records and replays in the other, through
rotation, garbage collection, a torn tail and a corrupt record, with the
same `torn_skipped` / `corrupt_skipped`; the door replays an admitted
but incomplete generate through a port `ModelServer` to the JAX
package's tokens, preloads durable outcomes across a restart, and
answers a retry from its ring without a new device step.
"""
import itertools
import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    generate as jax_generate,
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.serving import chaos as jax_chaos  # noqa: E402
from deeplearning4j_tpu.serving import exactly_once as jax_eo  # noqa: E402
from deeplearning4j_tpu.serving.observability import (  # noqa: E402
    EXACTLY_ONCE_STATS_KEYS as JAX_EXACTLY_ONCE_STATS_KEYS,
)
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.ops import paged_attention as pa  # noqa: E402
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DedupCache,
    ExactlyOnceDoor,
    JournalCorruptionInjector,
    ModelServer,
    RequestJournal,
    ResultPendingError,
    UnknownRequestError,
)
from deeplearning4j_tpu_torch.serving import chaos  # noqa: E402
from deeplearning4j_tpu_torch.serving import exactly_once as eo  # noqa: E402
from deeplearning4j_tpu_torch.serving.observability import (  # noqa: E402
    EXACTLY_ONCE_STATS_KEYS,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)

VOCAB = 48
WEDGE_GUARD_S = 120
PKGS = {"port": (eo, chaos), "jax": (jax_eo, jax_chaos)}


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


@pytest.fixture(autouse=True)
def _wedge_guard():
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def boom(signum, frame):
        raise TimeoutError(
            f"exactly-once test exceeded the {WEDGE_GUARD_S} s guard")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(WEDGE_GUARD_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNet(jax_gpt_configuration(vocab_size=VOCAB, d_model=32,
                                        n_heads=2, n_layers=2, max_length=64,
                                        seed=12345))
    jnet.init()
    pnet = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, [
        {k: np.asarray(v) for k, v in p.items()} for p in jnet._params]))
    return jnet, pnet


GEN = {"n_slots": 2, "max_len": 48, "prompt_buckets": (8,)}


# ------------------------------------------------------ the dedup ring
def _run_cache(mod, script, **kw):
    cache = mod.DedupCache(**kw)
    trace = []
    for op in script:
        kind, args = op[0], op[1:]
        try:
            if kind == "sleep":
                time.sleep(args[0])
            elif kind == "stats":
                trace.append(cache.stats())
            else:
                trace.append(getattr(cache, kind)(*args))
        except Exception as e:  # the trace records the typed error
            trace.append((type(e).__name__, str(e),
                          getattr(e, "retry_after", None)))
    return trace


CACHE_SCRIPTS = {
    "verdict_ladder": ({"capacity": 8, "ttl": 60.0}, [
        ("begin", "r1"), ("begin", "r1"), ("complete", "r1", {"result": 42}),
        ("begin", "r1"), ("stats",)]),
    "abandon_reexecutes": ({"capacity": 8, "ttl": 60.0}, [
        ("begin", "r1"), ("abandon", "r1"), ("begin", "r1"),
        ("complete", "r1", {"result": 1}), ("stats",)]),
    "capacity_and_ttl": ({"capacity": 2, "ttl": 0.1}, [
        ("begin", "a"), ("complete", "a", {"result": "a"}),
        ("begin", "b"), ("complete", "b", {"result": "b"}),
        ("begin", "c"), ("complete", "c", {"result": "c"}), ("stats",),
        ("begin", "a"), ("sleep", 0.25), ("begin", "b"), ("stats",)]),
    "claim_ladder": ({"capacity": 8, "ttl": 0.15,
                      "pending_retry_after": 0.25}, [
        ("begin", "r1"), ("claim", "r1"), ("complete", "r1", {"result": 1}),
        ("claim", "r1"), ("sleep", 0.3), ("claim", "r1"),
        ("claim", "nobody"), ("stats",)]),
    "durable_load": ({"capacity": 2, "ttl": 60.0}, [
        ("load", "x", {"result": 9}), ("load", "x", {"result": 8}),
        ("begin", "x"), ("claim", "x"), ("load", "y", {"result": 1}),
        ("load", "z", {"result": 2}), ("claim", "x"), ("stats",)]),
    "double_completion_counted": ({"capacity": 8, "ttl": 60.0}, [
        ("begin", "r"), ("complete", "r", {"result": 1}),
        ("complete", "r", {"result": 2}), ("claim", "r"), ("stats",)]),
}


@pytest.mark.parametrize("name", sorted(CACHE_SCRIPTS))
def test_dedup_cache_script_matches_jax(name):
    kw, script = CACHE_SCRIPTS[name]
    assert _run_cache(eo, script, **kw) == _run_cache(jax_eo, script, **kw)


def test_claim_ladder_is_typed():
    cache = DedupCache(capacity=8, ttl=0.15)
    assert cache.begin("r1")[0] == "execute"
    with pytest.raises(ResultPendingError) as ei:
        cache.claim("r1")
    assert ei.value.retry_after > 0
    cache.complete("r1", {"result": "done"})
    assert cache.claim("r1") == {"result": "done"}
    time.sleep(0.3)
    with pytest.raises(UnknownRequestError, match="TTL"):
        cache.claim("r1")
    with pytest.raises(UnknownRequestError, match="never admitted"):
        cache.claim("nobody-sent-this")


@pytest.mark.parametrize("kw,match", [({"capacity": 0}, "capacity"),
                                      ({"ttl": 0}, "ttl")])
def test_dedup_cache_validation(kw, match):
    for mod in (eo, jax_eo):
        with pytest.raises(ValueError, match=match):
            mod.DedupCache(**kw)


def test_stats_keys_and_rpc_classes_are_the_contract():
    assert EXACTLY_ONCE_STATS_KEYS == JAX_EXACTLY_ONCE_STATS_KEYS
    assert set(DedupCache().stats()) == EXACTLY_ONCE_STATS_KEYS
    assert eo.DEDUPED_RPCS == jax_eo.DEDUPED_RPCS
    assert eo.SIDE_EFFECT_FREE_RPCS == jax_eo.SIDE_EFFECT_FREE_RPCS
    assert eo.JOURNALED_RPCS == jax_eo.JOURNALED_RPCS
    assert not eo.DEDUPED_RPCS & eo.SIDE_EFFECT_FREE_RPCS


# ------------------------------------------------------ the journal
RECORDS = [
    ("admit", "g1", "generate", {"prompt": [1, 2, 3], "n_tokens": 4}),
    ("admit", "f1", "fit", {"epochs": 1}),
    ("admit", "p1", "predict", {"x": [[0.5, 1.5]]}),
    ("complete", "f1", {"result": 0.25}),
    ("void", "p1"),
    ("admit", "g2", "generate", {"prompt": [4], "n_tokens": 2}),
    ("complete", "g2", {"result": [7, 8]}),
    ("admit", "g3", "generate_stream", {"prompt": [5, 6], "n_tokens": 3}),
    ("admit", "g1", "generate", {"prompt": [1, 2, 3], "n_tokens": 4}),
]


def _write(mod, root, records=RECORDS, **kw):
    kw.setdefault("fsync", False)
    j = mod.RequestJournal(root, **kw)
    for rec in records:
        if rec[0] == "admit":
            j.admit(rec[1], rec[2], rec[3])
        elif rec[0] == "complete":
            j.complete(rec[1], rec[2])
        else:
            j.complete(rec[1], None, void=True)
    j.close()


def _read(mod, root, **kw):
    kw.setdefault("fsync", False)
    j = mod.RequestJournal(root, **kw)
    try:
        return {"pending": [(r["request_id"], r["method"], r["params"],
                             r["seq"]) for r in j.pending_records()],
                "completed": j.completed_outcomes(),
                "by_method": j.completed_by_method(),
                "stats": j.stats()}
    finally:
        j.close()


@pytest.fixture()
def wall_clock(monkeypatch):
    """A deterministic wall clock: the journal stamps records with
    `time.time()`, so both packages write the same bytes. Call the
    fixture's value to restart the clock."""
    tick = [itertools.count()]
    monkeypatch.setattr(time, "time", lambda: 1.7e9 + next(tick[0]))

    def restart():
        tick[0] = itertools.count()
    return restart


def _damage(chaos_mod, root, how):
    inj = chaos_mod.JournalCorruptionInjector()
    if how == "torn_tail":
        inj.torn_tail(root)
    elif how == "corrupt_record":
        inj.corrupt_record(root, index=1)
    elif how == "both":
        inj.torn_tail(root)
        inj.corrupt_record(root, index=0)
    return inj.corruptions


@pytest.mark.parametrize("rotate", [0, 3], ids=["one_segment", "rotated"])
def test_journal_bytes_equal_the_jax_packages(tmp_path, wall_clock, rotate):
    """The same admits and completes give byte-identical segment files
    (sorted-key JSON lines with the body's `crc32_hex`, the same
    segment names and rotation)."""
    kw = {"segment_max_records": rotate} if rotate else {}
    _write(eo, tmp_path / "port", **kw)
    wall_clock()
    _write(jax_eo, tmp_path / "jax", **kw)
    port = sorted((tmp_path / "port").glob("journal-*.wal"))
    ref = sorted((tmp_path / "jax").glob("journal-*.wal"))
    assert [p.name for p in port] == [p.name for p in ref]
    assert len(port) == (3 if rotate else 1)
    for a, b in zip(port, ref):
        assert a.read_bytes() == b.read_bytes()
    line = json.loads(port[0].read_bytes().splitlines()[0])
    assert set(line) == {"crc", "rec"}


@pytest.mark.parametrize("damage", ["none", "torn_tail", "corrupt_record",
                                    "both"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_written_by_one_package_replays_in_the_other(
        tmp_path, writer, damage):
    """A journal (three segments) written by `writer`, damaged by that
    package's `JournalCorruptionInjector`, loads in both packages to the
    same pending records, durable outcomes, per-method counts and
    `torn_skipped` / `corrupt_skipped`."""
    wmod, wchaos = PKGS[writer]
    _write(wmod, tmp_path, segment_max_records=3)
    n = _damage(wchaos, tmp_path, damage)
    assert n == {"none": 0, "both": 2}.get(damage, 1)
    got, want = _read(eo, tmp_path), _read(jax_eo, tmp_path)
    assert got == want
    st = got["stats"]
    assert st["torn_skipped"] == int(damage in ("torn_tail", "both"))
    assert st["corrupt_skipped"] == int(damage in ("corrupt_record", "both"))
    if damage == "none":
        assert [p[0] for p in got["pending"]] == ["g1", "g3"]
        assert got["completed"] == {"f1": {"result": 0.25},
                                    "g2": {"result": [7, 8]}}
        assert got["by_method"] == {"fit": 1, "predict": 1, "generate": 1}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_appends_after_the_other_packages_segments(tmp_path,
                                                           writer):
    """A journal reopened by the other package continues its sequence
    and segment names; the first package reads the whole ledger back."""
    wmod, _ = PKGS[writer]
    other = jax_eo if wmod is eo else eo
    _write(wmod, tmp_path, segment_max_records=3)
    j = other.RequestJournal(tmp_path, segment_max_records=3, fsync=False)
    j.complete("g1", {"result": [1, 1, 1, 1]})
    j.admit("g4", "generate", {"prompt": [9], "n_tokens": 1})
    j.close()
    got, want = _read(wmod, tmp_path), _read(other, tmp_path)
    assert got == want
    assert [p[0] for p in got["pending"]] == ["g3", "g4"]
    assert got["completed"]["g1"] == {"result": [1, 1, 1, 1]}
    assert len(set(p[3] for p in got["pending"])) == 2


@pytest.mark.parametrize("mod", [eo, jax_eo], ids=["port", "jax"])
def test_journal_rotation_and_gc_balance(tmp_path, mod):
    """After every admit completes and the horizon passes, the journal
    drains back to one (current) segment and zero pending, in both
    packages alike."""
    j = mod.RequestJournal(tmp_path, segment_max_records=2, gc_ttl=0.15,
                           fsync=False)
    for i in range(4):
        j.admit(f"r{i}", "predict", {})
        j.complete(f"r{i}", {"result": i})
    assert j.stats()["segments"] > 1
    time.sleep(0.3)
    j.admit("r-live", "predict", {})
    assert j.gc() == 1
    st = j.stats()
    assert st["pending"] == 1 and st["completed"] == 0
    assert st["gc_segments"] >= 1
    assert len(list(tmp_path.glob("journal-*.wal"))) == 1
    j.close()
    other = jax_eo if mod is eo else eo
    back = _read(other, tmp_path)
    assert [p[0] for p in back["pending"]] == ["r-live"]


def test_journal_validation():
    with pytest.raises(ValueError, match="segment_max_records"):
        RequestJournal("unused-dir-never-created", segment_max_records=0)


def test_journal_corruption_injector_needs_segments(tmp_path):
    with pytest.raises(FileNotFoundError, match="no journal segments"):
        JournalCorruptionInjector().torn_tail(tmp_path)


# ----------------------------------------------------------- the door
def test_door_replay_rides_the_gate_and_the_ready_predicate(tmp_path):
    door = ExactlyOnceDoor(journal_dir=tmp_path,
                           journal_kwargs={"fsync": False})
    assert door.admit("g1", "generate", {"name": "a"})[0] == "execute"
    assert door.admit("g2", "generate", {"name": "b"})[0] == "execute"
    door.close()
    door2 = ExactlyOnceDoor(journal_dir=tmp_path,
                            journal_kwargs={"fsync": False})
    executed = []

    def execute(method, params):
        executed.append(params["name"])
        return {"result": params["name"]}

    assert door2.replay(execute, ready=lambda m, p: p["name"] == "a") == 1
    assert door2.admit("g1", "generate", {"name": "a"}) \
        == ("cached", {"result": "a"})
    assert door2.replay(execute) == 1 and executed == ["a", "b"]
    assert door2.replay(execute) == 0
    st = door2.stats()
    assert st["replays"] == 2 and st["cache"]["double_executions"] == 0
    assert st["journal"]["pending"] == 0
    door2.close()


def test_door_retryable_replay_resolves_void(tmp_path):
    door = ExactlyOnceDoor(journal_dir=tmp_path,
                           journal_kwargs={"fsync": False})
    door.admit("r1", "predict", {})
    door.close()
    door2 = ExactlyOnceDoor(journal_dir=tmp_path,
                            journal_kwargs={"fsync": False})
    shed = {"error": "overloaded", "error_type": "ServerOverloadedError",
            "retry_after": 0.1}
    assert door2.replay(lambda m, p: dict(shed)) == 1
    assert door2.journal.stats()["pending"] == 0
    assert door2.admit("r1", "predict", {})[0] == "execute"
    door2.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_door_durable_outcomes_preload_across_restart(tmp_path, writer):
    """Durable completes written by either package's door preload the
    port door's ring: the retry is cached, not re-executed."""
    wmod, _ = PKGS[writer]
    door = wmod.ExactlyOnceDoor(journal_dir=tmp_path,
                                journal_kwargs={"fsync": False})
    door.admit("f1", "fit", {"epochs": 1})
    door.complete("f1", {"result": 0.25})
    door.close()
    door2 = ExactlyOnceDoor(journal_dir=tmp_path,
                            journal_kwargs={"fsync": False})
    st = door2.stats()
    assert st["cache"]["durable_loaded"] == 1
    assert st["completed_by_method"] == {"fit": 1}
    assert door2.admit("f1", "fit", {"epochs": 1}) \
        == ("cached", {"result": 0.25})
    assert door2.stats()["cache"]["executions"] == 0
    door2.close()


def _generate_outcome(srv):
    def execute(method, params):
        out = srv.generate(np.asarray(params["prompt"], np.int32),
                           int(params["n_tokens"]), timeout=120.0)
        return {"result": np.asarray(out).tolist()}
    return execute


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_incomplete_admit_replays_through_a_fresh_door(tmp_path, nets,
                                                       writer):
    """An admitted generate with no complete record, journaled by either
    package, replays through a fresh port door onto a port
    `ModelServer`; the claimed tokens equal the JAX package's
    `generate` on the same weights."""
    jnet, pnet = nets
    prompt = np.random.default_rng(4).integers(0, VOCAB, 8).astype(np.int32)
    wmod, _ = PKGS[writer]
    j = wmod.RequestJournal(tmp_path, fsync=False)
    j.admit("orphan", "generate", {"prompt": prompt.tolist(),
                                   "n_tokens": 6})
    j.close()
    srv = ModelServer(pnet, generation=GEN)
    door = ExactlyOnceDoor(journal_dir=tmp_path,
                           journal_kwargs={"fsync": False})
    try:
        assert door.replay(_generate_outcome(srv)) == 1
        got = door.claim("orphan")["result"]
        want = np.asarray(jax_generate(jnet, prompt[None], 6,
                                       temperature=0.0))[0].tolist()
        assert got == want
        st = door.stats()
        assert st["replays"] == 1 and st["journal"]["pending"] == 0
        assert st["cache"]["double_executions"] == 0
    finally:
        door.close()
        srv.shutdown(drain_timeout=30.0)


def test_retry_is_answered_by_the_door_without_a_device_step(tmp_path,
                                                             nets):
    """A stamped generate executes once; its retry returns the stored
    outcome (plain int lists, no tensors), the device is not touched
    again (no paged-attention call), and `double_executions` stays 0."""
    srv = ModelServer(nets[1], generation=GEN)
    door = ExactlyOnceDoor(journal_dir=tmp_path,
                           journal_kwargs={"fsync": False})
    execute = _generate_outcome(srv)
    params = {"prompt": [3, 1, 4, 1, 5, 9, 2, 6], "n_tokens": 5}
    try:
        verdict, _ = door.admit("r1", "generate", params)
        assert verdict == "execute"
        outcome = execute("generate", params)
        door.complete("r1", outcome)
        assert all(type(t) is int for t in outcome["result"])
        pa.reset_counts()
        verdict, again = door.admit("r1", "generate", params)
        assert verdict == "cached" and again == outcome
        assert pa.paged_attention_plain.calls == 0
        assert pa.paged_attention.launches == 0
        st = door.stats()["cache"]
        assert st["double_executions"] == 0 and st["executions"] == 1
        assert st["dedup_hits"] == 1
        assert door.stats()["journal"]["completed"] == 1
    finally:
        door.close()
        srv.shutdown(drain_timeout=30.0)
