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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_forward_row_tiles_match_pallas_interpret(masked, reverse):
    """What the cluster kernels' row tiles rest on, forward: `lstm_fused`
    run on independent tiles of batch rows (3, 3 and a ragged 2) and
    concatenated equals the JAX package's Pallas forward (interpret mode)
    on the whole batch, masked and reverse; tolerance 1e-5 (f32)."""
    a = _inputs(4)
    mask = _mask() if masked else None
    jo, (jh, jc) = _jax(a, np.float32, mask, reverse)
    parts = []
    for rows in (slice(0, 3), slice(3, 6), slice(6, 8)):
        tile = dict(a, x=a["x"][rows], h0=a["h0"][rows], c0=a["c0"][rows])
        parts.append(_port(tile, np.float32,
                           None if mask is None else mask[rows], reverse))
    po = torch.cat([o for o, _ in parts], dim=0)
    ph = torch.cat([hc[0] for _, hc in parts], dim=0)
    pc = torch.cat([hc[1] for _, hc in parts], dim=0)
    for got, want in ((po, jo), (ph, jh), (pc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 5])
def test_odd_h_padded_by_zero_units(masked, n):
    """What the wrappers do in bf16 for an H that is not a multiple of 8
    (`_padded_units`; H = 7 gets n = 1, and n = 5 as for H = 3): the
    plain forward and backward on H + n units, the extra units' weights,
    bias, peepholes, carries and cotangents zero, then cut, equal the
    unpadded ones in f64 (forward outputs, stash, dz, dh0 and dc0; rtol
    1e-12: the padded units add exact zeros)."""
    rng = np.random.default_rng(9)
    Tn, Bn, Hn = 4, 3, 7
    r = lambda *s, sc=1.0: torch.from_numpy(rng.standard_normal(s) * sc)
    xw, rw, peep = r(Tn, Bn, 4 * Hn), r(Hn, 4 * Hn, sc=0.4), r(3, Hn, sc=0.3)
    h0, c0, dh, dhT, dcT = (r(Bn, Hn), r(Bn, Hn), r(Tn, Bn, Hn), r(Bn, Hn),
                            r(Bn, Hn))
    mask = None
    if masked:
        mask = torch.from_numpy((np.arange(Tn)[:, None]
                                 < np.array([4, 0, 2])[None]).astype(float))

    def pad(t, what):
        return L._padded_units(t, what, n)

    fwd = L.lstm_fwd_plain(xw, rw, peep, h0, c0, mask)
    fwd_p = L.lstm_fwd_plain(pad(xw, "gates"), pad(rw, "rw"),
                             pad(peep, "units"), pad(h0, "units"),
                             pad(c0, "units"), mask)
    for i, (want, got) in enumerate(zip(fwd, fwd_p)):
        if want is None:
            continue
        cut = L._gates_cut(got, Hn) if i == 5 else L._units_cut(got, Hn)
        np.testing.assert_allclose(cut.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-14)
    dhT_ = dhT if masked else None
    want = L.lstm_bwd_plain(fwd[5], fwd[4], dh, dhT_, dcT, rw, peep, c0, mask)
    got = L.lstm_bwd_plain(fwd_p[5], fwd_p[4], pad(dh, "units"),
                           None if dhT_ is None else pad(dhT_, "units"),
                           pad(dcT, "units"), pad(rw, "rw"),
                           pad(peep, "units"), pad(c0, "units"), mask)
    np.testing.assert_allclose(L._gates_cut(got[0], Hn).numpy(),
                               want[0].numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(L._units_cut(got[1], Hn).numpy(),
                               want[1].numpy(), rtol=1e-12, atol=1e-14)
    assert float(got[0].reshape(Tn, Bn, 4, Hn + n)[..., Hn:].abs().max()) == 0


def test_rw_by_unit_group_puts_a_units_gates_in_one_operand():
    """The bf16 cluster forward's B operand (`_rw_by_unit_group`): row
    256 G + 64 q + j holds column q H + 64 G + j of RW, zeros past H in
    both axes (H = 100: two unit groups, the second ragged)."""
    Hn = 100
    rw = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (Hn, 4 * Hn)))
    p = L._rw_by_unit_group(rw)
    assert tuple(p.shape) == (4 * 128, 104)
    for G in range(2):
        for q in range(4):
            for j in range(64):
                u, row = 64 * G + j, p[256 * G + 64 * q + j]
                want = rw[:, q * Hn + u] if u < Hn else torch.zeros(Hn)
                assert torch.equal(row[:Hn], want)
    assert float(p[:, Hn:].abs().max()) == 0


def test_rw_by_unit_group_32_for_the_split_tf32_forward():
    """The split-TF32 forward's B operand (`_rw_by_unit_group(rw, 32, 4)`):
    row 128 G + 32 q + j holds column q H + 32 G + j of RW, k padded to a
    multiple of 4 and units to a multiple of 64 with zeros (H = 70: three
    32-unit groups, the third ragged, and a fourth of zeros)."""
    Hn = 70
    rw = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (Hn, 4 * Hn)).astype(np.float32))
    p = L._rw_by_unit_group(rw, 32, 4)
    assert tuple(p.shape) == (4 * 128, 72)
    for G in range(4):
        for q in range(4):
            for j in range(32):
                u, row = 32 * G + j, p[128 * G + 32 * q + j]
                want = rw[:, q * Hn + u] if u < Hn else torch.zeros(Hn)
                assert torch.equal(row[:Hn], want)
    assert float(p[:, Hn:].abs().max()) == 0


def test_rw_by_unit_group_8_for_the_cooperative_forward():
    """The cooperative forward's B operand (`_rw_by_unit_group(rw, 8, 8)`):
    block G's 32 rows 32 G + 8 q + j hold column q H + 8 G + j of RW,
    units padded to a multiple of 64 with zeros (H = 200, the wrapper's
    padding of 196: 25 blocks of 8 units, 7 more of zeros)."""
    Hn = 200
    rw = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (Hn, 4 * Hn)).astype(np.float32))
    p = L._rw_by_unit_group(rw, 8, 8)
    assert tuple(p.shape) == (4 * 256, 200)
    for G in range(32):
        for q in range(4):
            for j in range(8):
                u, row = 8 * G + j, p[32 * G + 8 * q + j]
                want = rw[:, q * Hn + u] if u < Hn else torch.zeros(Hn)
                assert torch.equal(row, want)


def test_tf32_planes_split_as_the_kernels_do():
    """`_tf32_planes` (the wrapper's split of h0 into the forward's first
    operand planes) is the kernels' `split_tf32`: big rounded to nearest
    with ties away from zero, small the rounded rest, big + small within
    2^-22 of x; non-finite values stay in big."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20,
                      3.0, float("inf"), float("nan")])
    big, small = L._tf32_planes(x)
    assert torch.equal(big[:4], torch.tensor([1 + ulp, -(1 + ulp), 1.0, 3.0]))
    assert big[4] == float("inf") and bool(torch.isnan(big[5]))
    assert torch.equal(small[3:], torch.zeros(3))
    v = torch.from_numpy(np.random.default_rng(21).standard_normal(4096)
                         .astype(np.float32) * 7)
    big, small = L._tf32_planes(v)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((big + small - v).abs() <= 2.0 ** -22 * v.abs()).all())


def _mm_tf32(a, b, passes, chunk=32):
    """The kernels' recurrent product a @ b (f32) on the tensor cores: each
    operand rounded to TF32 (one pass) or split into two TF32 parts
    (three passes: a_small b_big + a_big b_small + a_big b_big), every
    32-wide chunk of K summed on its own and the chunks added in f32."""
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], chunk):
        x, y = a[:, k0:k0 + chunk], b[k0:k0 + chunk]
        xb, yb = L._tf32(x), L._tf32(y)
        part = xb @ yb
        if passes == 3:
            part = (L._tf32(x - xb) @ yb + xb @ L._tf32(y - yb)) + part
        out = out + part
    return out


def _emulated_fwd(xw, rw, peep, h0, c0, mask, passes):
    """`lstm_fwd_plain`'s recurrence (forward order) with the product of
    the kernels (`_mm_tf32`): (h_out, hT or None, cT, h_sel or None, c,
    gates)."""
    T, B_, G = xw.shape
    Hn = G // 4
    h, c = h0.clone(), c0.clone()
    outs = ([], [], [], [])
    for t in range(T):
        z = xw[t] + _mm_tf32(h, rw, passes)
        i = torch.sigmoid(z[:, :Hn] + peep[0] * c)
        f = torch.sigmoid(z[:, Hn:2 * Hn] + peep[1] * c)
        g = torch.tanh(z[:, 3 * Hn:])
        cn = f * c + i * g
        o = torch.sigmoid(z[:, 2 * Hn:3 * Hn] + peep[2] * cn)
        hn = o * torch.tanh(cn)
        if mask is None:
            h, c, out = hn, cn, hn
        else:
            m = mask[t][:, None]
            h, c = torch.where(m > 0, hn, h), torch.where(m > 0, cn, c)
            out = h * m
        for lst, v in zip(outs, (out, c, h, torch.cat([i, f, o, g], 1))):
            lst.append(v)
    h_out, c_st, h_st, gates = (torch.stack(v) for v in outs)
    return (h_out, None if mask is None else h, c,
            None if mask is None else h_st, c_st, gates)


def _emulated_bwd(gates, c_st, dh_out, dhT, dcT, rw, peep, c0, mask, passes):
    """`lstm_bwd_plain`'s recurrence (forward order) with the product of
    the kernels: (dz, dhc0)."""
    T, B_, G = gates.shape
    Hn = G // 4
    dh = torch.zeros((B_, Hn)) if dhT is None else dhT.clone()
    dc = dcT.clone()
    dz = torch.empty_like(gates)
    for t in range(T - 1, -1, -1):
        i, f, o, g = (gates[t][:, k * Hn:(k + 1) * Hn] for k in range(4))
        c_prev = c0 if t == 0 else c_st[t - 1]
        if mask is None:
            c_t, dh_new, dc_new = c_st[t], dh_out[t] + dh, dc
            byp_h = byp_c = 0.0
        else:
            m = mask[t][:, None]
            c_t = f * c_prev + i * g
            d_hsel = m * dh_out[t] + dh
            zero = torch.zeros_like(d_hsel)
            dh_new = torch.where(m > 0, d_hsel, zero)
            byp_h = torch.where(m > 0, zero, d_hsel)
            dc_new = torch.where(m > 0, dc, zero)
            byp_c = torch.where(m > 0, zero, dc)
        tc = torch.tanh(c_t)
        dzo = dh_new * tc * o * (1.0 - o)
        dct = dh_new * o * (1.0 - tc * tc) + dc_new + dzo * peep[2]
        dzg = dct * i * (1.0 - g * g)
        dzi = dct * g * i * (1.0 - i)
        dzf = dct * c_prev * f * (1.0 - f)
        dz[t] = torch.cat([dzi, dzf, dzo, dzg], dim=1)
        dh = _mm_tf32(dz[t], rw.T.contiguous(), passes) + byp_h
        dc = dct * f + dzi * peep[0] + dzf * peep[1] + byp_c
    return dz, torch.stack([dh, dc])


@pytest.mark.parametrize("masked", [False, True])
def test_f32_tolerance_accepts_split_tf32_and_rejects_one_pass(masked):
    """The f32 check (`L.error_in_tolerances`, TOLERANCE[float32] = 1e-4,
    row by row) tells the split-TF32 kernels from one TF32 pass: their
    recurrence emulated on the CPU (T=16, B=8, H=256; every step's
    product in TF32, 32-wide k chunks summed apart and added in f32, the
    backward on the emulated forward's own stash) stays within 0.1 of the
    tolerance of `lstm_fwd_plain` / `lstm_bwd_plain` in every output with
    three passes, and lands outside it with one."""
    Tn, Bn, Hn = 16, 8, 256
    rng = np.random.default_rng(40 + masked)
    r = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32))
    xw, rw = r(Tn, Bn, 4 * Hn), r(Hn, 4 * Hn, sc=Hn ** -0.5)
    peep, h0, c0 = r(3, Hn, sc=0.3), r(Bn, Hn, sc=0.5), r(Bn, Hn, sc=0.5)
    dh, dhT, dcT = r(Tn, Bn, Hn), r(Bn, Hn), r(Bn, Hn)
    mask = None
    if masked:
        mask = torch.from_numpy((np.arange(Tn)[:, None] < np.array(
            [Tn, 0, 5, Tn, 1, 9, 13, 7])[None]).astype(np.float32))
        mask[Tn // 2, 3] = 0.0
    worst = {}
    for passes in (3, 1):
        got = _emulated_fwd(xw, rw, peep, h0, c0, mask, passes)
        ref = L.lstm_fwd_plain(xw, rw, peep, h0, c0, mask)
        d_args = (got[5], got[4], dh, dhT if masked else None, dcT, rw, peep,
                  c0, mask)
        gb = _emulated_bwd(*d_args, passes)
        rb = L.lstm_bwd_plain(*d_args)
        units = [L.error_in_tolerances(a, b, torch.float32)
                 for a, b in zip(list(got) + list(gb), list(ref) + list(rb))
                 if a is not None]
        worst[passes] = (max(units[:-2]), max(units[-2:]))
    assert max(worst[3]) <= 0.1, worst
    assert min(worst[1]) > 1.0, worst


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
    """The bf16 forward at H=2048, which the cooperative grid could not
    hold (CUDA error 720 before), now runs as clusters of 16 blocks of
    128 units and 64 rows, held to the plain version; the cooperative
    kernel keeps the batches it takes (B <= 128 at H <= 1024), whose grid
    fits the card."""
    _card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(8)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda")
                            * sc).to(dt)
    H2 = 2048
    p = L.plan("fwd", dt, False, 16, H2)
    assert (p.route, p.cluster, p.units, p.rows) == ("bf16 clusters", 16,
                                                     128, 64)
    assert p.active >= 1
    xw, rw = r(2, 16, 4 * H2), r(H2, 4 * H2, sc=H2 ** -0.5)
    peep, h0, c0 = r(3, H2, sc=0.3), r(16, H2, sc=0.5), r(16, H2, sc=0.5)
    got = L.lstm_fwd(xw, rw, peep, h0, c0)
    want = L.lstm_fwd_plain(xw, rw, peep, h0, c0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if a is not None:
            assert L.error_in_tolerances(a, b, dt) <= 1.0
    coop = L.plan("fwd", dt, False, 128, 1024)
    assert coop.route == "cooperative" and coop.gx * coop.gy <= coop.active


@pytest.mark.gpu
@pytest.mark.parametrize("Hn", [1024, 196])
def test_cooperative_forward_small_batches(Hn):
    """The cooperative bf16 forward at B = 1, 31, 32, 33 (the warpgroups
    split K at 64 rows or fewer) and 100, masked and not, forward and
    reverse, with its stash and without: every launch on "cooperative",
    every output held row by row to the plain version, and a second run
    bit-identical to the first."""
    _card()
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(9)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device="cuda")
                            * sc).to(dt)
    Tn = 20
    rw, peep = r(Hn, 4 * Hn, sc=Hn ** -0.5), r(3, Hn, sc=0.3)
    for Bn in (1, 31, 32, 33, 100):
        xw, h0, c0 = r(Tn, Bn, 4 * Hn), r(Bn, Hn, sc=0.5), r(Bn, Hn, sc=0.5)
        mask = (torch.arange(Tn, device="cuda")[:, None]
                < torch.arange(1, Bn + 1, device="cuda")[None] % (Tn + 1)
                ).to(dt)
        for m in (None, mask):
            for reverse in (False, True):
                L.reset_counts()
                runs = [[t for stash in (True, False)
                         for t in L.lstm_fwd(xw, rw, peep, h0, c0, m,
                                             reverse=reverse,
                                             with_stash=stash)]
                        for _ in range(2)]
                ref = L.lstm_fwd_plain(xw, rw, peep, h0, c0, m,
                                       reverse=reverse)
                torch.cuda.synchronize()
                assert L.launches_by_route == {("fwd", "cooperative"): 4}
                for a, b in zip(runs[0], list(ref) + list(ref)):
                    if a is not None:
                        assert L.error_in_tolerances(a, b, dt) <= 1.0
                for a, b in zip(*runs):
                    assert (a is None) == (b is None)
                    assert a is None or torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_backward_clusters_and_refusals():
    """The bf16 backward runs H=2048 as clusters of 16 blocks (on a stash
    the plain forward made on the card) and an odd H (195: the wrapper
    pads it to 200 with zero units, then cuts them off) within tolerance;
    above 2048 both passes refuse before any launch, naming why (the four
    gates of a unit in one thread's accumulator, 16 blocks of 128 units
    the most a cluster holds)."""
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

    p = L.plan("bwd", dt, False, 256, 2048)
    assert (p.cluster, p.rows, p.units) == (16, 128, 128) and p.active >= 1
    for args in (stash_args(2, 256, 2048), stash_args(2, 37, 195)):
        got = L.lstm_bwd(*args)
        want = L.lstm_bwd_plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert L.error_in_tolerances(a, b, dt) <= 1.0
    L.reset_counts()
    args = stash_args(1, 8, 2176)
    with pytest.raises(ValueError, match="16 blocks of 128"):
        L.lstm_bwd(*args)
    with pytest.raises(ValueError, match="16 blocks of 128"):
        L.lstm_fwd(r(1, 8, 4 * 2176), args[5], args[6], args[7], args[7])
    assert not L.launches


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_f32_split_tf32_kernels(masked, reverse):
    """The f32 kernels against the plain versions (the backward on the
    forward kernel's stash) at B = 1, 37, 300 and H = 196, 385 (ragged:
    a block part-filled, a cluster with an idle block at 385) and 2048
    (clusters of 16, the forward in two passes); the forward without its
    stash gives the same bits as with it; a rerun gives the same bits;
    every launch on the split-TF32 route."""
    _card()
    dt = torch.float32
    g = torch.Generator(device="cuda").manual_seed(12)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    for Bn in (1, 37, 300):
        for Hn in (196, 385, 2048):
            Tn = 3
            xw, rw = r(Tn, Bn, 4 * Hn), r(Hn, 4 * Hn, sc=Hn ** -0.5)
            peep, h0, c0 = r(3, Hn, sc=0.3), r(Bn, Hn, sc=0.5), r(Bn, Hn,
                                                                   sc=0.5)
            dh, dhT, dcT = r(Tn, Bn, Hn), r(Bn, Hn), r(Bn, Hn)
            m = None
            if masked:
                m = (torch.arange(Tn, device="cuda")[:, None]
                     < torch.arange(Bn, device="cuda")[None] % (Tn + 1)).to(dt)
            routes = {kind: L.plan(kind, dt, masked, Bn, Hn).route
                      for kind in ("fwd", "bwd")}
            assert routes == {"fwd": "tf32 clusters", "bwd": "tf32 clusters"}
            runs = []
            for _ in range(2):
                L.reset_counts()
                got = L.lstm_fwd(xw, rw, peep, h0, c0, m, reverse=reverse)
                gb = L.lstm_bwd(got[5], got[4], dh, dhT if masked else None,
                                dcT, rw, peep, c0, m, reverse=reverse)
                torch.cuda.synchronize()
                assert L.launches_by_route == {("fwd", routes["fwd"]): 1,
                                               ("bwd", routes["bwd"]): 1}
                runs.append(list(got) + list(gb))
            for a, b in zip(*runs):
                assert a is None or torch.equal(a, b)
            ref = L.lstm_fwd_plain(xw, rw, peep, h0, c0, m, reverse=reverse)
            rb = L.lstm_bwd_plain(got[5], got[4], dh,
                                  dhT if masked else None, dcT, rw, peep, c0,
                                  m, reverse=reverse)
            for a, b in zip(list(got) + list(gb), list(ref) + list(rb)):
                if a is not None:
                    assert L.error_in_tolerances(a, b, dt) <= 1.0
            lean = L.lstm_fwd(xw, rw, peep, h0, c0, m, reverse=reverse,
                              with_stash=False)
            for a, b in zip(lean[:3], got[:3]):
                assert a is None or torch.equal(a, b)


@pytest.mark.gpu
def test_f32_launch_plans():
    """`plan` for f32: the split-TF32 forward as clusters (rounded up to
    a power of two) of 64-row blocks, 64 units a block up to H = 1024 and
    128 (two passes) above; the backward of 128 rows x 128 units; up to
    H = 2048; every plan fits the card."""
    _card()
    dt = torch.float32
    for masked in (False, True):
        for Hn, units, c_fwd, c_bwd in ((196, 64, 4, 2), (385, 64, 8, 4),
                                        (1024, 64, 16, 8),
                                        (2048, 128, 16, 16)):
            pf = L.plan("fwd", dt, masked, 2048, Hn)
            pb = L.plan("bwd", dt, masked, 2048, Hn)
            assert (pf.route, pf.rows, pf.units, pf.cluster) == (
                "tf32 clusters", 64, units, c_fwd)
            assert (pb.route, pb.rows, pb.units, pb.cluster) == (
                "tf32 clusters", 128, 128, c_bwd)
            assert pf.active >= 1 and pb.active >= 1
