"""The port's fused LSTM (`ops/lstm.py`) held against the JAX package's
Pallas LSTM on the CPU.

The JAX side is `lstm_fused_or_none(..., interpret=True)`, the Pallas
kernels run by the interpreter (as `tests/test_pallas_lstm.py` runs
them); the port's side is `lstm_fused` on CPU tensors, which runs the
kernels' plain versions. Inputs (H=128, B=8, T=6, nIn=16, nonzero h0, c0
and peepholes; masks with ragged lengths, a row masked from t=0, a row
never masked and a hole) are made with numpy from a seed.

Tolerances: f32 forward (out, hT, cT) 1e-5 absolute; gradients of a
scalar loss in every input (dx, dW, dRW, db, dpeep, dh0, dc0) in f64,
under a scoped `jax.enable_x64`, rtol 1e-10 + atol 1e-12 (the two sum in
different orders). The CUDA kernels run only on the card: the
`gpu`-marked tests hold them to the plain versions
(`python -m pytest -m gpu tests/test_torch_*.py`).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.layers.recurrent import (  # noqa: E402
    lstm_forward as jlstm_forward,
)
from deeplearning4j_tpu.ops.pallas_lstm import (  # noqa: E402
    lstm_fused_or_none,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: E402
    lstm_forward,
)
from deeplearning4j_tpu_torch.ops import lstm as L  # noqa: E402

B, T, NI, H = 8, 6, 16, 128


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: rng.standard_normal(s) * sc
    return dict(x=r(B, T, NI), W=r(NI, 4 * H, sc=0.2), RW=r(H, 4 * H, sc=0.2),
                b=r(4 * H, sc=0.1), peep=[r(H, sc=0.1) for _ in range(3)],
                h0=r(B, H, sc=0.5), c0=r(B, H, sc=0.5))


def _mask():
    lens = np.array([T, 0, 3, T, 1, 2, 5, 4])
    m = (np.arange(T)[None] < lens[:, None]).astype(np.float64)
    m[3, 2] = 0.0   # a hole in a row that is otherwise never masked
    return m


def _jax(a, dt, mask, reverse):
    j = lambda v: jnp.asarray(np.asarray(v, dt))
    res = lstm_fused_or_none(
        j(a["x"]), j(a["W"]), j(a["RW"]), j(a["b"]),
        tuple(j(p) for p in a["peep"]), j(a["h0"]), j(a["c0"]),
        gate_is_sigmoid=True, cell_is_tanh=True,
        mask=None if mask is None else j(mask), reverse=reverse,
        interpret=True)
    assert res is not None
    return res


def _port(a, dt, mask, reverse):
    t = lambda v: torch.from_numpy(np.asarray(v, dt))
    return L.lstm_fused(t(a["x"]), t(a["W"]), t(a["RW"]), t(a["b"]),
                        [t(p) for p in a["peep"]], t(a["h0"]), t(a["c0"]),
                        mask=None if mask is None else t(mask),
                        reverse=reverse)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_forward_matches_pallas_interpret(masked, reverse):
    a = _inputs()
    mask = _mask() if masked else None
    jo, (jh, jc) = _jax(a, np.float32, mask, reverse)
    L.reset_counts()
    po, (ph, pc) = _port(a, np.float32, mask, reverse)
    assert L.lstm_fwd_plain.calls == 1 and not L.launches
    for got, want in ((po, jo), (ph, jh), (pc, jc)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_gradients_match_pallas_interpret_f64(masked, reverse):
    a = _inputs(1)
    mask = _mask() if masked else None
    wts = np.random.default_rng(2).standard_normal((B, T, H))
    names = ("x", "W", "RW", "b", "pI", "pF", "pO", "h0", "c0")
    vals = [a["x"], a["W"], a["RW"], a["b"], *a["peep"], a["h0"], a["c0"]]
    with jax.enable_x64(True):
        jm = None if mask is None else jnp.asarray(mask)

        def loss(x, W, RW, b, pI, pF, pO, h0, c0):
            out, (hT, cT) = lstm_fused_or_none(
                x, W, RW, b, (pI, pF, pO), h0, c0, gate_is_sigmoid=True,
                cell_is_tanh=True, mask=jm, reverse=reverse, interpret=True)
            return (jnp.sum(out * jnp.asarray(wts)) + jnp.sum(hT * cT)
                    + jnp.sum(jnp.tanh(cT)))

        jg = jax.grad(loss, argnums=tuple(range(9)))(
            *(jnp.asarray(v, jnp.float64) for v in vals))
        jg = [np.asarray(g) for g in jg]
    leaves = [torch.from_numpy(np.asarray(v, np.float64)).requires_grad_()
              for v in vals]
    x, W, RW, b, pI, pF, pO, h0, c0 = leaves
    L.reset_counts()
    out, (hT, cT) = L.lstm_fused(
        x, W, RW, b, (pI, pF, pO), h0, c0, reverse=reverse,
        mask=None if mask is None else torch.from_numpy(mask))
    (torch.sum(out * torch.from_numpy(wts)) + torch.sum(hT * cT)
     + torch.sum(torch.tanh(cT))).backward()
    assert (L.lstm_fwd_plain.calls, L.lstm_bwd_plain.calls) == (1, 1)
    for n, t, g in zip(names, leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-10, atol=1e-12,
                                   err_msg=n)


def test_other_activations_take_the_plain_loop():
    """A hard-sigmoid gate is not the fused kernel's function: the plain
    time loop runs, equal to the JAX package's scan path."""
    a = _inputs(3)
    mask = _mask()
    j = lambda v: jnp.asarray(np.asarray(v, np.float32))
    hs = lambda v: jnp.clip(0.2 * v + 0.5, 0.0, 1.0)
    jo, (jh, jc) = jlstm_forward(
        j(a["x"]), j(a["W"]), j(a["RW"]), j(a["b"]),
        tuple(j(p) for p in a["peep"]), hs, jnp.tanh, j(a["h0"]), j(a["c0"]),
        j(mask), gate_is_sigmoid=False, cell_is_tanh=True)
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32))
    lstm_forward.routes.update(fused=0, loop=0)
    L.reset_counts()
    po, (ph, pc) = lstm_forward(
        t(a["x"]), t(a["W"]), t(a["RW"]), t(a["b"]),
        tuple(t(p) for p in a["peep"]),
        lambda v: torch.clamp(0.2 * v + 0.5, 0.0, 1.0), torch.tanh,
        t(a["h0"]), t(a["c0"]), t(mask), gate_is_sigmoid=False,
        cell_is_tanh=True)
    assert lstm_forward.routes == {"fused": 0, "loop": 1}
    assert L.lstm_fwd_plain.calls == 0
    for got, want in ((po, jo), (ph, jh), (pc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_error_in_tolerances_reads_rows():
    ref = torch.tensor([[1.0, -2.0], [1e-3, 2e-3]])
    assert L.error_in_tolerances(ref, ref, torch.float32) == 0.0
    off = ref.clone()
    off[0, 1] += 1e-4
    assert L.error_in_tolerances(off, ref, torch.float32) == \
        pytest.approx(0.5, rel=1e-3)
    off[1, 0] = float("nan")
    assert L.error_in_tolerances(off, ref, torch.float32) == float("inf")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_rows_are_independent(masked, reverse):
    """What the bf16 backward kernel's row tiles rest on: the recurrence
    couples no batch rows, so the plain backward on two halves of the
    batch equals it on the whole (dz and dh0/dc0 row for row; the halves
    differ from the whole only in the order of their f32 sums)."""
    rng = np.random.default_rng(7)
    Tn, Bn, Hn = 5, 10, 24
    r = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32))
    xw, rw = r(Tn, Bn, 4 * Hn), r(Hn, 4 * Hn, sc=Hn ** -0.5)
    peep, h0, c0 = r(3, Hn, sc=0.3), r(Bn, Hn, sc=0.5), r(Bn, Hn, sc=0.5)
    dh, dhT, dcT = r(Tn, Bn, Hn), r(Bn, Hn), r(Bn, Hn)
    mask = None
    if masked:
        lens = np.array([5, 0, 3, 5, 1, 2, 4, 5, 3, 2])
        mask = torch.from_numpy(
            (np.arange(Tn)[:, None] < lens[None]).astype(np.float32))
        mask[2, 3] = 0.0  # a hole
    _, _, _, _, c_st, gates = L.lstm_fwd_plain(xw, rw, peep, h0, c0, mask,
                                               reverse=reverse)

    def bwd(rows):
        return L.lstm_bwd_plain(
            gates[:, rows], c_st[:, rows], dh[:, rows],
            None if mask is None else dhT[rows], dcT[rows], rw, peep,
            c0[rows], None if mask is None else mask[:, rows],
            reverse=reverse)

    dz, dhc0 = bwd(slice(None))
    halves = [bwd(slice(0, 4)), bwd(slice(4, None))]
    np.testing.assert_allclose(
        torch.cat([h[0] for h in halves], dim=1).numpy(), dz.numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        torch.cat([h[1] for h in halves], dim=1).numpy(), dhc0.numpy(),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain(dtype):
    """Forward (with its stash) and backward kernels against the plain
    versions on the same inputs, masked and not, forward and reverse, a
    ragged H, B not a multiple of the bf16 backward's 128-row tiles, and
    H=384 (a cluster of four 128-unit tiles, one idle); the backward on
    the forward kernel's own stash; within `L.error_in_tolerances`."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda")
                            * sc).to(dt)
    for (Tn, Bn, Hn) in ((5, 8, 128), (3, 37, 196), (2, 300, 384)):
        xw, rw = r(Tn, Bn, 4 * Hn), r(Hn, 4 * Hn, sc=Hn ** -0.5)
        peep, h0, c0 = r(3, Hn, sc=0.3), r(Bn, Hn, sc=0.5), r(Bn, Hn, sc=0.5)
        dh, dhT, dcT = r(Tn, Bn, Hn), r(Bn, Hn), r(Bn, Hn)
        mask = (torch.arange(Tn, device="cuda")[:, None]
                < torch.arange(Bn, device="cuda")[None] % (Tn + 1)).to(dt)
        for m in (None, mask):
            for reverse in (False, True):
                L.reset_counts()
                got = L.lstm_fwd(xw, rw, peep, h0, c0, m, reverse=reverse)
                ref = L.lstm_fwd_plain(xw, rw, peep, h0, c0, m,
                                       reverse=reverse)
                gb = L.lstm_bwd(got[5], got[4], dh,
                                None if m is None else dhT, dcT, rw, peep,
                                c0, m, reverse=reverse)
                rb = L.lstm_bwd_plain(got[5], got[4], dh,
                                      None if m is None else dhT, dcT, rw,
                                      peep, c0, m, reverse=reverse)
                torch.cuda.synchronize()
                assert L.launches == {("fwd", m is not None, reverse): 1,
                                      ("bwd", m is not None, reverse): 1}
                for a, b in list(zip(got, ref)) + list(zip(gb, rb)):
                    if a is not None:
                        assert L.error_in_tolerances(a, b, dt) <= 1.0


@pytest.mark.gpu
def test_cooperative_launch_too_large_raises():
    """The forward (still one cooperative launch) refuses a grid larger
    than the blocks that can be resident: CUDA error 720 at launch, and
    the wrapper raises naming the grid. (The bf16 backward runs this
    width as clusters: `test_bf16_backward_clusters_and_refusals`.)"""
    _card()
    H2 = 2048
    z = torch.zeros((2, 16, 4 * H2), dtype=torch.bfloat16, device="cuda")
    rw = torch.zeros((H2, 4 * H2), dtype=torch.bfloat16, device="cuda")
    peep = torch.zeros((3, H2), dtype=torch.bfloat16, device="cuda")
    h = torch.zeros((16, H2), dtype=torch.bfloat16, device="cuda")
    smem, gu, gb, rows, cap, cluster, units = L.plan(
        "fwd", torch.bfloat16, False, 16, H2)
    assert gu * gb > cap and cluster == 1
    with pytest.raises(RuntimeError, match="720"):
        L.lstm_fwd(z, rw, peep, h, h)


@pytest.mark.gpu
def test_bf16_backward_clusters_and_refusals():
    """The bf16 backward runs H=2048 as clusters of 16 blocks (on a stash
    the plain forward made on the card: the cooperative forward refuses
    that width) within tolerance, and refuses, naming why, an odd H (TMA
    rows of 4H bf16 must be 16-byte multiples) and H above 2048 (a
    cluster above 16 blocks)."""
    _card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(6)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda")
                            * sc).to(dt)

    def stash_args(Tn, Bn, Hn):
        xw, rw = r(Tn, Bn, 4 * Hn), r(Hn, 4 * Hn, sc=Hn ** -0.5)
        peep, h0, c0 = r(3, Hn, sc=0.3), r(Bn, Hn), r(Bn, Hn)
        st = L.lstm_fwd_plain(xw, rw, peep, h0, c0)
        return (st[5], st[4], r(Tn, Bn, Hn), None, r(Bn, Hn), rw, peep, c0)

    smem, gu, gb, rows, active, cluster, units = L.plan(
        "bwd", dt, False, 256, 2048)
    assert (cluster, rows, units) == (16, 128, 128) and active >= 1
    args = stash_args(2, 256, 2048)
    got = L.lstm_bwd(*args)
    want = L.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert L.error_in_tolerances(a, b, dt) <= 1.0
    with pytest.raises(ValueError, match="odd H"):
        L.lstm_bwd(*stash_args(1, 8, 195))
    with pytest.raises(ValueError, match="16 blocks per cluster"):
        L.lstm_bwd(*stash_args(1, 8, 2176))
