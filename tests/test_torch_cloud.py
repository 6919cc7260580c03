"""The port's cloud tier (`deeplearning4j_tpu_torch.cloud`,
`CheckpointStore.upload` / `download`) against the JAX package's, with no
egress: the storage backends against a fake GCS client and a flaky local
store, the provisioning descriptor against a fake `gcloud`.

Held: the same keys and the same bytes in the bucket whichever package
wrote them (a dataset's `.npz`, a model's zip, a checkpoint and its
manifest), each package reading what the other wrote (arrays bit for
bit, restored parameters exactly equal); the same retry counts and typed
errors on the same injected faults; the same rendered and executed
commands."""
import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.cloud import provision as jprov  # noqa: E402
from deeplearning4j_tpu.cloud import storage as jst  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu.util import checkpoint_store as jcs  # noqa: E402

from deeplearning4j_tpu_torch.cloud import provision as pprov  # noqa: E402
from deeplearning4j_tpu_torch.cloud import storage as pst  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    AsyncDataSetIterator,
)
from deeplearning4j_tpu_torch.util import checkpoint_store as pcs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several pytest-xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- fake GCS
class _FakeBlob:
    def __init__(self, store, name):
        self._store, self.name = store, name

    def upload_from_string(self, data) -> None:
        self._store[self.name] = (data.encode()
                                  if isinstance(data, str) else bytes(data))

    def download_as_bytes(self) -> bytes:
        return self._store[self.name]

    def exists(self) -> bool:
        return self.name in self._store


class _FakeBucket:
    def __init__(self, store):
        self._store = store

    def blob(self, name):
        return _FakeBlob(self._store, name)

    def list_blobs(self, prefix=""):
        return [_FakeBlob(self._store, k) for k in sorted(self._store)
                if k.startswith(prefix)]


class FakeGCSClient:
    """The client surface GCSStorage consumes, over a dict (the JAX
    package's test double)."""

    def __init__(self):
        self.store = {}

    def bucket(self, name):
        return _FakeBucket(self.store)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((4, 3)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)],
             np.ones((4,), np.float32) if i % 2 else None)
            for i in range(n)]


def test_gcs_objects_are_the_jax_packages_bytes():
    """Both packages' GCSStorage put the same datasets: the same keys and
    the same bytes in the bucket, and each reads the other's."""
    client_p, client_j = FakeGCSClient(), FakeGCSClient()
    p = pst.GCSStorage("bkt", prefix="runs/a", client=client_p)
    j = jst.GCSStorage("bkt", prefix="runs/a", client=client_j)
    for i, (f, l, m) in enumerate(_batches(3)):
        p.put_dataset(f"batch{i}", DataSet(f, l, None, m))
        j.put_dataset(f"batch{i}", JDataSet(f, l, None, m))
    assert client_p.store == client_j.store
    assert p.list_keys() == j.list_keys() == ["batch0", "batch1", "batch2"]
    assert p.exists("batch0") and not p.exists("nope")
    cross = pst.GCSStorage("bkt", prefix="runs/a", client=client_j)
    for k in p.list_keys():
        a, b = cross.get_dataset(k), j.get_dataset(k)
        for f in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_gcs_prefix_isolation_and_the_streaming_iterator():
    client = FakeGCSClient()
    a = pst.GCSStorage("bkt", prefix="job-a", client=client)
    b = pst.GCSStorage("bkt", prefix="job-b", client=client)
    for i, (f, l, _) in enumerate(_batches(12, seed=1)):
        a.put_dataset(f"d{i}", DataSet(f, l))
    b.put_dataset("other", DataSet(np.zeros((1, 3), np.float32),
                                   np.zeros((1, 2), np.float32)))
    assert b.list_keys() == ["other"]
    order = [d for d in pst.StorageDataSetIterator(a)]
    want = [d for d in jst.StorageDataSetIterator(jst.GCSStorage(
        "bkt", prefix="job-a", client=client))]
    assert len(order) == len(want) == 12  # natural order: d2 before d10
    for x, y in zip(order, want):
        np.testing.assert_array_equal(x.features, y.features)
    it = AsyncDataSetIterator(pst.StorageDataSetIterator(a), 2)
    assert sum(1 for _ in it) == 12


def _jnet():
    conf = (dl4j.NeuralNetConfiguration.Builder().seed(9).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=3, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=2))
            .build())
    net = dl4j.MultiLayerNetwork(conf)
    net.init()
    return net


def test_models_cross_the_bucket_both_ways():
    """A JAX-package model put in the bucket restores in the port (on the
    CPU, exactly), and the port's model restores in the JAX package."""
    client = FakeGCSClient()
    jnet = _jnet()
    jst.GCSStorage("bkt", client=client).put_model("jax.zip", jnet)
    p = pst.GCSStorage("bkt", client=client)
    pnet = p.get_model("jax.zip", device="cpu")
    np.testing.assert_array_equal(pnet.params().numpy(),
                                  np.asarray(jnet.params()))
    pnet.fit(DataSet(*_batches(1)[0][:2]))
    p.put_model("port.zip", pnet)
    back = jst.GCSStorage("bkt", client=client).get_model("port.zip")
    np.testing.assert_array_equal(np.asarray(back.params()),
                                  pnet.params().numpy())


def test_local_storage_refuses_escaping_keys(tmp_path):
    st = pst.LocalStorage(tmp_path / "bucket")
    st.put_bytes("a/b", b"x")
    assert st.list_keys() == ["a/b"] and st.get_bytes("a/b") == b"x"
    for bad in ("../evil", "../bucket-evil/x"):
        with pytest.raises(ValueError, match="escapes"):
            st.put_bytes(bad, b"x")


# ------------------------------------------------------------ flaky store
class _Flaky:
    """A LocalStorage of either package that fails or corrupts on cue
    (the JAX package's test double)."""

    def __init__(self, local, fail_puts=0, fail_gets=0, corrupt_gets=0,
                 corrupt_stored=0):
        self.inner = local
        self.fail_puts, self.fail_gets = fail_puts, fail_gets
        self.corrupt_gets, self.corrupt_stored = corrupt_gets, corrupt_stored

    def put_bytes(self, key, data):
        if self.fail_puts > 0:
            self.fail_puts -= 1
            raise ConnectionError("injected put failure")
        if self.corrupt_stored > 0:
            self.corrupt_stored -= 1
            data = data[:-1] + bytes([data[-1] ^ 0xFF])
        self.inner.put_bytes(key, data)

    def get_bytes(self, key):
        if self.fail_gets > 0:
            self.fail_gets -= 1
            raise ConnectionError("injected get failure")
        data = self.inner.get_bytes(key)
        if self.corrupt_gets > 0:
            self.corrupt_gets -= 1
            return data[:-1] + bytes([data[-1] ^ 0xFF])
        return data

    def list_keys(self, prefix=""):
        return self.inner.list_keys(prefix)

    def exists(self, key):
        return self.inner.exists(key)


@pytest.mark.parametrize("fault", ["transient", "corrupt_upload",
                                   "exhausted", "corrupt_download"])
def test_retrying_storage_matches_the_jax_package(fault, tmp_path):
    """The same faults give the same retries and the same typed errors
    in both packages."""
    import hashlib

    def run(st_mod, cs_mod, root):
        kw = {"transient": dict(fail_puts=1, fail_gets=1),
              "corrupt_upload": dict(corrupt_stored=1),
              "exhausted": dict(corrupt_stored=99),
              "corrupt_download": dict(corrupt_gets=0)}[fault]
        flaky = _Flaky(st_mod.LocalStorage(root), **kw)
        st = st_mod.RetryingStorage(flaky, max_retries=2, backoff=0.001)
        try:
            st.put_bytes("k", b"important bytes")
            if fault == "corrupt_download":
                flaky.corrupt_gets = 1
                got = st.get_bytes("k", expected_sha256=hashlib.sha256(
                    b"important bytes").hexdigest())
            else:
                got = st.get_bytes("k")
        except cs_mod.CheckpointCorruptError as e:
            return ("CheckpointCorruptError", str(e), st.retries)
        return (got, st.attempts, st.retries)

    assert run(pst, pcs, tmp_path / "p") == run(jst, jcs, tmp_path / "j")


# ---------------------------------------------- CheckpointStore transfer
def _saved(cs_mod, root, steps):
    store = cs_mod.CheckpointStore(root, keep_last=5)
    for s in steps:
        store.save_bytes(s, f"payload-{s}".encode())
    return store


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port")])
def test_checkpoints_travel_between_the_packages(src, dst, tmp_path):
    """A checkpoint uploaded by one package downloads in the other: the
    same keys (payload, then manifest), the manifest re-verified, and a
    corrupt newest checkpoint skipped for the last good one; a failed
    put, a read-back that comes back corrupt and a failed get retry."""
    mods = {"port": (pst, pcs), "jax": (jst, jcs)}
    (st_a, cs_a), (st_b, cs_b) = mods[src], mods[dst]
    store = _saved(cs_a, tmp_path / "local", [1, 2])
    bucket = st_a.LocalStorage(tmp_path / "bucket")
    key = store.upload(_Flaky(bucket, fail_puts=1, corrupt_gets=1),
                       "ckpts", backoff=0.001)
    assert key == "ckpts/checkpoint_2.zip"
    assert bucket.list_keys("ckpts") == [
        "ckpts/checkpoint_2.zip", "ckpts/checkpoint_2.zip.manifest.json"]
    fresh = cs_b.CheckpointStore(tmp_path / "restored")
    path = fresh.download(_Flaky(st_b.LocalStorage(tmp_path / "bucket"),
                                 fail_gets=1), "ckpts", backoff=0.001)
    assert Path(path).read_bytes() == b"payload-2"
    fresh.verify(2)
    # a flipped byte in the newest local checkpoint: upload the last good
    p2 = store.path_for(2)
    raw = bytearray(p2.read_bytes())
    raw[0] ^= 0xFF
    p2.write_bytes(bytes(raw))
    assert store.upload(bucket, "again", backoff=0.001) \
        == "again/checkpoint_1.zip"


def test_download_of_a_missing_prefix_raises_as_the_jax_package(tmp_path):
    for st_mod, cs_mod in ((pst, pcs), (jst, jcs)):
        with pytest.raises(FileNotFoundError, match="no remote"):
            cs_mod.CheckpointStore(tmp_path / "r").download(
                st_mod.LocalStorage(tmp_path / "empty"), "nothing")


# ---------------------------------------------------------- provisioning
def _fake_gcloud(tmp_path, rc=0):
    log = tmp_path / "calls.jsonl"
    script = tmp_path / "fake-gcloud"
    script.write_text(
        "#!/usr/bin/env python3\n"
        "import json, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "print('done')\n"
        + ("sys.stderr.write('quota exceeded\\n')\n" if rc else "")
        + f"sys.exit({rc})\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script, log


def test_the_pod_spec_renders_the_jax_packages_commands():
    kw = dict(name="pod0", accelerator_type="v4-32", zone="us-east5-b",
              project="proj", preemptible=True, labels={"team": "ml", "a": "b"})
    p, j = pprov.TpuPodSpec(**kw), jprov.TpuPodSpec(**kw)
    assert p.create_command() == j.create_command()
    assert p.delete_command() == j.delete_command()
    assert p.ssh_command("0", "hostname") == j.ssh_command("0", "hostname")
    assert p.num_chips == j.num_chips


def test_cluster_setup_runs_what_it_renders(tmp_path):
    script, log = _fake_gcloud(tmp_path)
    spec = pprov.TpuPodSpec(name="pod0", project="proj")
    setup = pprov.ClusterSetup(spec, gcloud_binary=str(script))
    assert setup.create(execute=False)[0] == str(script)
    assert not log.exists()
    assert setup.create(execute=True).returncode == 0
    setup.ssh("hostname", worker="0", execute=True)
    setup.delete(execute=True)
    calls = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert calls == [spec.create_command()[1:],
                     spec.ssh_command("0", "hostname")[1:],
                     spec.delete_command()[1:]]
    (tmp_path / "failing").mkdir()
    bad, _ = _fake_gcloud(tmp_path / "failing", rc=2)
    with pytest.raises(RuntimeError, match="quota exceeded"):
        pprov.ClusterSetup(spec, gcloud_binary=str(bad)).create(execute=True)


def test_the_provision_cli_executes_with_the_port(tmp_path):
    script, log = _fake_gcloud(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cloud.provision",
         "create", "--name", "cli-pod", "--zone", "eu-west4-a",
         "--execute", "--gcloud", str(script)],
        capture_output=True, text=True, timeout=60, cwd=str(REPO),
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-1500:]
    assert "EXECUTED rc=0" in out.stdout
    call = json.loads(log.read_text().splitlines()[0])
    assert "cli-pod" in call and "--zone=eu-west4-a" in call
