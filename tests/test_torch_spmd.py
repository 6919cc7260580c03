"""The port's in-process SPMD runtime (`parallel/spmd.py`), its slots
(`parallel/mesh.py`) and partition-invariant dropout (`ops/rng_rows.py`)
on the CPU.

Every collective is held against numpy on an 8-slot CPU mesh (the
counterpart of the JAX tests' eight forced host devices), and
`all_to_all`'s split/concat semantics against `jax.shard_map` with
`lax.all_to_all` on those devices. Also pinned: gradients flow back
through the collectives as `jax.grad` through a `shard_map` does; a
raising body raises the whole call and releases the other slots; slots
that call different collectives raise instead of hanging; each slot
thread takes the caller's grad mode, aux-loss scope and row offset; the
slot list; and dropout masks that depend on the global row only.
Tolerances: exact (f64 sums in slot order) unless stated.
"""
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from deeplearning4j_tpu_torch.nn.conf.layers import dropout  # noqa: E402
from deeplearning4j_tpu_torch.ops import aux_loss, rng_rows  # noqa: E402
from deeplearning4j_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel import spmd  # noqa: E402
from deeplearning4j_tpu_torch.parallel.spmd import P, Sharded  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return pmesh.make_mesh(axes, devices=[CPU] * n)


def _x(shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape))


# ---------------------------------------------------------- collectives
def test_psum_pmean_and_axis_index_against_numpy():
    mesh = _mesh({"data": 2, "x": 4})
    x = _x((8, 3))

    def body(a):
        return (spmd.psum(a, "x"), spmd.pmean(a, ("data", "x")),
                torch.full((1,), float(spmd.axis_index(("data", "x")))),
                torch.full((1,), float(spmd.axis_index("x"))))

    spec = P(("data", "x"))
    s, m, idx, ix = spmd.shard_map(body, mesh, in_specs=(spec,),
                                   out_specs=(spec,) * 4)(x)
    xs = x.numpy().reshape(2, 4, 3)
    np.testing.assert_array_equal(
        s.numpy().reshape(2, 4, 3),
        np.repeat(xs.sum(1, keepdims=True), 4, axis=1))
    np.testing.assert_allclose(m.numpy(), np.tile(x.numpy().mean(0), (8, 1)),
                               rtol=1e-14)
    np.testing.assert_array_equal(idx.numpy(), np.arange(8))
    np.testing.assert_array_equal(ix.numpy(), np.tile(np.arange(4), 2))


def test_psum_adds_in_slot_order():
    """Every slot's sum has the same bits, those of the slot-order sum."""
    mesh = _mesh({"x": 8})
    x = torch.tensor([1e16, 1.0, -1e16, 1.0, 3.0, -3.0, 0.5, 0.25],
                     dtype=torch.float64)[:, None]
    out = spmd.shard_map(lambda a: spmd.psum(a, "x"), mesh,
                         in_specs=(P("x"),), out_specs=P("x"))(x)
    acc = x[0]
    for t in x[1:]:
        acc = acc + t
    assert torch.equal(out, acc.expand(8, 1))


@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_against_numpy(shift):
    mesh = _mesh({"data": 2, "x": 4})
    x = _x((8, 2), 1)
    perm = [(i, (i + shift) % 4) for i in range(4)]
    out = spmd.shard_map(lambda a: spmd.ppermute(a, "x", perm), mesh,
                         in_specs=(P(("data", "x")),),
                         out_specs=P(("data", "x")))(x)
    np.testing.assert_array_equal(
        out.numpy().reshape(2, 4, 2),
        np.roll(x.numpy().reshape(2, 4, 2), shift, axis=1))
    # a slot no pair sends to gets zeros
    half = spmd.shard_map(lambda a: spmd.ppermute(a, "x", [(0, 1)]), mesh,
                          in_specs=(P(("data", "x")),),
                          out_specs=P(("data", "x")))(x)
    got = half.numpy().reshape(2, 4, 2)
    np.testing.assert_array_equal(got[:, 1], x.numpy().reshape(2, 4, 2)[:, 0])
    assert not got[:, [0, 2, 3]].any()


@pytest.mark.parametrize("split,concat", [(0, 0), (1, 0), (0, 1), (2, 1)])
def test_all_to_all_tiled_against_jax(split, concat):
    """Tiled all_to_all, held against `lax.all_to_all` under
    `jax.shard_map` on the JAX tests' forced host devices."""
    n = 4
    devs = jax.devices()[:n]
    x = np.random.default_rng(2).normal(size=(n * 4, 8, 4)).astype(np.float32)
    jmesh = JaxMesh(np.asarray(devs), ("x",))
    want = jax.shard_map(
        lambda a: jax.lax.all_to_all(a, "x", split, concat, tiled=True),
        mesh=jmesh, in_specs=(JP("x"),), out_specs=JP("x"),
        check_vma=False)(jnp.asarray(x))
    got = spmd.shard_map(
        lambda a: spmd.all_to_all(a, "x", split, concat, tiled=True),
        _mesh({"x": n}), in_specs=(P("x"),), out_specs=P("x"))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_all_to_all_untiled_and_all_gather_against_numpy():
    mesh = _mesh({"x": 4})
    x = _x((16, 3), 3)           # 4 rows a slot: one per destination
    out = spmd.shard_map(
        lambda a: spmd.all_to_all(a, "x", 0, 1, tiled=False), mesh,
        in_specs=(P("x"),), out_specs=P("x"))(x)
    xs = x.numpy().reshape(4, 4, 3)           # (source, dest, 3)
    np.testing.assert_array_equal(out.numpy().reshape(4, 3, 4),
                                  xs.transpose(1, 2, 0))
    g = spmd.shard_map(lambda a: spmd.all_gather(a, "x", axis=0, tiled=True),
                       mesh, in_specs=(P("x"),), out_specs=P())(x)
    np.testing.assert_array_equal(g.numpy(), x.numpy())
    s = spmd.shard_map(lambda a: spmd.all_gather(a, "x", axis=1), mesh,
                       in_specs=(P("x"),), out_specs=P())(x)
    np.testing.assert_array_equal(s.numpy(), xs.transpose(1, 0, 2))


def test_gradients_flow_back_through_the_collectives():
    """d/dx of sum(psum) is the group size, of a ppermute 1, of an
    all_to_all the inverse permutation: one backward() runs the reverse
    program."""
    mesh = _mesh({"x": 4})
    x = _x((8, 4), 4).requires_grad_(True)
    w = _x((8, 4), 5)

    def body(a, b):
        s = spmd.psum(a, "x")
        r = spmd.ppermute(a, "x", [(i, (i + 1) % 4) for i in range(4)])
        t = spmd.all_to_all(a, "x", 1, 1, tiled=True)
        return s, r, t * b

    s, r, t = spmd.shard_map(body, mesh, in_specs=(P("x"), P("x")),
                             out_specs=(P("x"),) * 3)(x, w)
    (s.sum() + 2.0 * r.sum() + t.sum()).backward()
    # all_to_all along the feature axis: slot i's column j lands in slot
    # j's column i, so d(t*w)/dx routes w back the same way
    wb = w.numpy().reshape(4, 2, 4)            # (slot, row, column)
    back = wb.transpose(2, 1, 0).reshape(8, 4)
    np.testing.assert_allclose(x.grad.numpy(), 4.0 + 2.0 + back,
                               rtol=1e-14)


# ------------------------------------------------------ failure handling
def test_a_raising_body_raises_and_releases_the_other_slots():
    """The call raises the body's exception; the other slots leave their
    rendezvous, no thread is left behind, and the next call runs."""
    mesh = _mesh({"x": 8})

    def body(a):
        if spmd.axis_index("x") == 3:
            raise KeyError("slot 3 failed")
        return spmd.psum(a, "x")

    good = spmd.shard_map(lambda a: spmd.psum(a, "x"), mesh,
                          in_specs=(P("x"),), out_specs=P("x"))
    bad = spmd.shard_map(body, mesh, in_specs=(P("x"),), out_specs=P("x"))
    good(torch.zeros((8, 1)))
    before = threading.active_count()
    for _ in range(2):
        with pytest.raises(KeyError, match="slot 3 failed"):
            bad(torch.zeros((8, 1)))
    assert torch.equal(good(torch.ones((8, 1))), torch.full((8, 1), 8.0))
    assert threading.active_count() == before


def test_a_body_may_run_a_program_of_its_own():
    """A per-slot body that calls shard_map on the same mesh runs that
    program on slot threads of its own."""
    mesh = _mesh({"x": 2})
    inner = spmd.shard_map(lambda a: spmd.psum(a, "x"), mesh,
                           in_specs=(P("x"),), out_specs=P())

    def body(a):
        return a + inner(torch.arange(2.0)[:, None])

    out = spmd.shard_map(body, mesh, in_specs=(P("x"),), out_specs=P("x"))(
        torch.zeros((2, 1)))
    assert torch.equal(out, torch.ones((2, 1)))


def test_mismatched_collectives_raise_instead_of_hanging():
    mesh = _mesh({"x": 4})

    def body(a):
        return a if spmd.axis_index("x") == 1 else spmd.psum(a, "x")

    with pytest.raises(RuntimeError, match="SPMD mismatch"):
        spmd.shard_map(body, mesh, in_specs=(P("x"),), out_specs=P("x"))(
            torch.zeros((4, 1)))
    with pytest.raises(RuntimeError, match="outside a shard_map body"):
        spmd.psum(torch.zeros(1), "x")


def test_slot_threads_take_the_callers_thread_state():
    """Grad mode, the row offset and the aux-loss scope reach every slot;
    slot 0's aux terms reach the caller's scope once."""
    mesh = _mesh({"x": 2})
    seen = []

    def body(a):
        seen.append((spmd.current_slot(), torch.is_grad_enabled(),
                     rng_rows.current_row_offset()))
        aux_loss.add_aux_loss(a.sum())
        return a

    with torch.no_grad(), rng_rows.row_offset_scope(5), \
            aux_loss.aux_loss_scope() as terms:
        spmd.shard_map(body, mesh, in_specs=(P("x"),), out_specs=P("x"))(
            torch.ones((2, 1)))
    assert sorted(seen) == [(0, False, 5), (1, False, 5)]
    assert len(terms) == 1 and float(terms[0]) == 1.0
    assert spmd.current_slot() is None


def test_sharded_values_keep_one_contiguous_tensor_per_slot():
    mesh = _mesh({"tp": 2})
    pool = torch.arange(3 * 4 * 2 * 2, dtype=torch.float32).reshape(3, 4, 2, 2)
    sh = Sharded.split(pool, P(None, "tp"), mesh)
    assert all(s.is_contiguous() and s.shape == (3, 2, 2, 2)
               for s in sh.shards)
    assert sh.shards[0].data_ptr() != pool.data_ptr()
    assert sh.shape == pool.shape and sh.nbytes == pool.nbytes
    idx = torch.tensor([2, 0])
    torch.testing.assert_close(sh[idx], pool[idx], rtol=0, atol=0)
    sh[torch.tensor([1])] = torch.full((1, 4, 2, 2), -1.0)
    assert torch.equal(sh.full()[1], torch.full((4, 2, 2), -1.0))
    assert torch.equal(sh.full()[0], pool[0])


# ------------------------------------------------------------------ slots
def test_local_slots_and_the_default_mesh():
    saved = pmesh._SLOTS
    try:
        pmesh.set_local_slots(None)
        if not torch.cuda.is_available():
            assert pmesh.local_slots() == []
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pmesh.make_mesh()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                pmesh.set_local_slots(2)
        pmesh.set_local_slots(3, "cpu")
        assert pmesh.local_slots() == [CPU] * 3
        assert pmesh.make_mesh().shape == {"data": 3}
        with pytest.raises(ValueError, match="positive int"):
            pmesh.set_local_slots(0, "cpu")
    finally:
        pmesh._SLOTS = saved


# --------------------------------------------------------------- dropout
def test_dropout_masks_depend_on_the_global_row_only():
    """Inside row_offset_scope, two halves of a batch at their global
    offsets draw exactly the whole batch's masks; keyed by the local row
    (offset 0 for both halves) the second half's masks differ; outside a
    scope the mask is the bulk draw."""
    x = torch.ones((6, 5, 7))
    rng = (9, 3, 2)
    with rng_rows.row_offset_scope(0):
        whole = dropout(x, 0.5, rng)
    with rng_rows.row_offset_scope(0):
        top = dropout(x[:3], 0.5, rng)
    with rng_rows.row_offset_scope(3):
        bottom = dropout(x[3:], 0.5, rng)
    assert torch.equal(torch.cat([top, bottom]), whole)
    with rng_rows.row_offset_scope(0):
        local = dropout(x[3:], 0.5, rng)
    assert not torch.equal(local, whole[3:])
    bulk = dropout(x, 0.5, rng)
    assert not torch.equal(bulk, whole)
    assert torch.equal(bulk, dropout(x, 0.5, rng))
    assert set(torch.unique(whole).tolist()) == {0.0, 2.0}
