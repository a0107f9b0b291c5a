"""The gather-kernel probes and the gather strategies: the port's plain
versions against the JAX probes.

``benchmarks/gather_kernel_probe.py`` is loaded by path, its Pallas kernels
run in interpret mode (``pallas_call`` patched to ``interpret=True``, the
file untouched), inside the JAX probe's domain: L a multiple of 128 (it
reshapes to (-1, 128)) and every read span inside ``flat``.  The kernels
are copies, so the port's plain P-a and P-s must equal them exactly, as
must each gather strategy's plain path equal the ``jnp`` expression the
JAX script times.  The card's kernels against these plain versions are in
``tests/test_torch_cuda.py``.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pcgnn_tpu.ops.pallas.ragged_gather import ragged_window_gather
from pcgnn_tpu_torch.benchmarks import gather_kernel_probe as tgkp
from pcgnn_tpu_torch.benchmarks import gather_probe as tgp
from pcgnn_tpu_torch.ops import gather_probe as gp
from pcgnn_tpu_torch.utils import roofline as troof

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_probe(monkeypatch):
    """``benchmarks/gather_kernel_probe.py`` with its kernels in interpret
    mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_gather_kernel_probe", ROOT / "benchmarks/gather_kernel_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(dp):
    return -(-dp // 1024) * 1024 + 1024


def _case(seed, b, dp, residues=None):
    """(flat [L], starts [B]) inside the JAX probe's domain: starts whose
    1024-aligned span of ceil(dp/1024)*1024 + 1024 lies inside flat.
    ``residues``: the starts' values mod 1024 (random by default)."""
    rng = np.random.default_rng(seed)
    blocks = 6
    length = blocks * 1024 + _span(dp)
    flat = rng.integers(-2 ** 30, 2 ** 30, length).astype(np.int32)
    if residues is None:
        residues = rng.integers(0, 1024, b)
    starts = rng.integers(0, blocks, b) * 1024 + np.asarray(residues)
    return flat, starts.astype(np.int32)


# B not a multiple of rows among them; dp from 128 to 2,048
SHIFT_CASES = [(1, 128, 8, 4), (5, 256, 8, 4), (13, 1152, 16, 8),
               (40, 2048, 32, 8), (21, 640, 32, 16), (70, 384, 64, 16)]
ALIGNED_CASES = [(1, 128, 8), (5, 256, 8), (13, 1152, 16), (40, 2048, 32),
                 (70, 384, 64)]


@pytest.mark.parametrize("b,dp,rows,slots", SHIFT_CASES)
def test_shift_plain_equals_jax_probe(jax_probe, b, dp, rows, slots):
    flat, starts = _case(b + dp, b, dp)
    want = np.asarray(jax_probe.shift_window_gather(
        jnp.asarray(flat), jnp.asarray(starts), dp, rows, slots))
    got = gp.shift_gather(torch.from_numpy(flat), torch.from_numpy(starts),
                          dp, rows, slots)
    assert got.dtype == torch.int32 and got.shape == (b, dp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,dp,rows", ALIGNED_CASES)
def test_aligned_plain_equals_jax_probe(jax_probe, b, dp, rows):
    flat, starts = _case(b * dp, b, dp)
    want = np.asarray(jax_probe.aligned_window_gather(
        jnp.asarray(flat), jnp.asarray(starts), dp, rows))
    got = gp.aligned_gather(torch.from_numpy(flat), torch.from_numpy(starts),
                            dp, rows)
    assert got.dtype == torch.int32 and got.shape == (b, dp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel", ["shift", "aligned"])
def test_every_start_residue_equals_jax_probe(jax_probe, kernel):
    """Starts at every value mod 1024 (so every mod 4 and mod 128 class),
    1,027 rows (not a multiple of the block's 8)."""
    residues = np.concatenate([np.random.default_rng(1).permutation(1024),
                               [0, 1023, 511]])
    dp = 128
    flat, starts = _case(7, len(residues), dp, residues)
    f, s = jnp.asarray(flat), jnp.asarray(starts)
    if kernel == "shift":
        want = jax_probe.shift_window_gather(f, s, dp, 8, 4)
        got = gp.shift_gather(torch.from_numpy(flat),
                              torch.from_numpy(starts), dp, 8, 4)
    else:
        want = jax_probe.aligned_window_gather(f, s, dp, 8)
        got = gp.aligned_gather(torch.from_numpy(flat),
                                torch.from_numpy(starts), dp, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_starts_outside_are_clamped():
    """A start outside [0, L - dp] is clamped into it before any rounding
    (the JAX probe leaves it undefined)."""
    flat = torch.arange(4096, dtype=torch.int32)
    dp = 256
    starts = torch.tensor([-5, -4096, 4096 - 256, 4000, 10 ** 9, 1500],
                          dtype=torch.int32)
    clamped = torch.tensor([0, 0, 3840, 3840, 3840, 1500])
    shift = gp.shift_gather(flat, starts, dp, 8, 4)
    aligned = gp.aligned_gather(flat, starts, dp, 8)
    assert torch.equal(shift[:, 0].long(), clamped)
    assert torch.equal(aligned[:, 0].long(), clamped // 1024 * 1024)
    assert torch.equal(shift, torch.stack([flat[s:s + dp] for s in clamped]))
    assert int(shift.max()) == 4095


def test_slot_caps_at_the_probe_width():
    """dp = 7,040: 8 slots of 28,160 (P-a) or 28,176 (P-s) bytes fit 227 KB
    with their barriers; the sweep's pairs are capped there."""
    assert gp.smem_bytes(8, 28176) <= gp.SMEM_LIMIT
    assert gp.smem_bytes(9, 28160) > gp.SMEM_LIMIT
    assert [gp.shift_slots(7040, r, k) for r, k in tgkp.SHIFT_SWEEP] == [
        4, 8, 8, 8, 8]
    assert [gp.aligned_slots(7040, r) for r in tgkp.ALIGNED_ROWS] == [
        8, 8, 8, 8]
    for slot_bytes in (16, 512, 28160, 116144):
        k = gp.slot_cap(slot_bytes)
        assert gp.smem_bytes(k, slot_bytes) <= gp.SMEM_LIMIT
        assert gp.smem_bytes(k + 1, slot_bytes) > gp.SMEM_LIMIT


@pytest.mark.parametrize("fn,dp_ok,dp_wide", [
    (lambda f, s, dp: gp.aligned_gather(f, s, dp, 8), 29040, 29044),
    (lambda f, s, dp: gp.shift_gather(f, s, dp, 8, 4), 29036, 29040)])
def test_refuses_a_row_too_wide_for_two_slots(fn, dp_ok, dp_wide):
    """The widest row that 2 slots and their barriers fit in 227 KB is
    taken, one 4-element unit wider is refused with the limit named."""
    flat = torch.zeros(1 << 16, dtype=torch.int32)
    starts = torch.zeros(3, dtype=torch.int32)
    assert fn(flat, starts, dp_ok).shape == (3, dp_ok)
    with pytest.raises(ValueError, match=f"{gp.SMEM_LIMIT} bytes of shared"):
        fn(flat, starts, dp_wide)


@pytest.mark.parametrize("flat,starts,dp,err", [
    (torch.zeros(4096, dtype=torch.float32), torch.zeros(2, dtype=torch.int32),
     128, TypeError),
    (torch.zeros(4096, dtype=torch.int32), torch.zeros(2, dtype=torch.int64),
     128, TypeError),
    (torch.zeros(4096, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
     130, ValueError),
    (torch.zeros(4098, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
     128, ValueError),
    (torch.zeros(64, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
     128, ValueError),
    (torch.zeros((2, 2048), dtype=torch.int32),
     torch.zeros(2, dtype=torch.int32), 128, ValueError)])
def test_refuses_what_the_kernels_do_not_take(flat, starts, dp, err):
    with pytest.raises(err):
        gp.aligned_gather(flat, starts, dp)
    with pytest.raises(err):
        gp.shift_gather(flat, starts, dp, 8, 4)


def _fake_timing(monkeypatch, calls, wall_ms=1.0):
    """``measure`` faked: it runs the call once on its first argument set
    and records its bytes."""
    def measure(fn, *args, analytic_bytes=None, analytic_flops=None,
                device=None, target_s=0.15, arg_sets=None):
        assert not args and len(arg_sets) == 8
        fn(*arg_sets[0])
        calls.append(analytic_bytes)
        return {"wall_ms": wall_ms, "readings_ms": [wall_ms] * 5,
                "achieved_gbps": analytic_bytes / 1e6, "sol_frac": 0.5}
    monkeypatch.setattr(troof, "measure", measure)


def test_kernel_probe_script_checks_every_variant(monkeypatch, capsys):
    """The probe path on the CPU with the timing faked: every variant of
    the JAX probe's sweep, each exact against its plain version on every
    set of starts, timed over the output bytes; the JAX script's
    correctness lines."""
    calls = []
    _fake_timing(monkeypatch, calls)
    res = tgkp.run(b=37, d=20, f=33, e=5000, device="cpu")
    dp = 768
    assert res["dp"] == dp and res["out_bytes"] == 37 * dp * 4
    assert res["rw_bytes"] == 2 * 37 * dp * 4 + 37 * 4
    assert res["start_sets"] == tgkp.START_SETS
    kinds = [r["kernel"] for r in res["rows"]]
    assert kinds == (["kernel 2", "kernel 1 copy", "kernel 1 copy aligned"]
                     + ["P-s"] * 5 + ["P-a"] * 4
                     + ["library", "plain P-s", "plain P-a"])
    assert all(r["exact"] and r["max_abs_err"] == 0 for r in res["rows"])
    assert all(r["wall_ms"] == 1.0 and r["readings_ms"] == [1.0] * 5
               for r in res["rows"])
    assert [(r["rows"], r["slots"]) for r in res["rows"]
            if r["kernel"] == "P-s"] == list(tgkp.SHIFT_SWEEP)
    assert calls == [37 * dp * 4] * len(res["rows"])
    out = capsys.readouterr().out
    assert "aligned correct: True" in out and "shift correct: True" in out


def test_kernel_probe_refuses_a_time_under_its_bound(monkeypatch):
    """A time under the read+write bound by more than ``SOL_LIMIT`` is a
    fault of the timing or of the count: the probe raises."""
    monkeypatch.setattr(troof, "chip_peaks", lambda device=None:
                        (3.35e12, 989e12))
    b, dp = 37, 768
    bound_ms = (2 * b * dp * 4 + b * 4) / 3.35e12 * 1e3
    _fake_timing(monkeypatch, [], wall_ms=bound_ms)
    res = tgkp.run(b=b, d=20, f=33, e=5000, device="cpu")
    assert all(r["rw_frac"] == pytest.approx(1.0) for r in res["rows"])
    _fake_timing(monkeypatch, [], wall_ms=bound_ms / 1.06)
    with pytest.raises(AssertionError, match="under its read\+write bound"):
        tgkp.run(b=b, d=20, f=33, e=5000, device="cpu")


def test_kernel_probe_refuses_a_wrong_variant(monkeypatch):
    _fake_timing(monkeypatch, [])
    monkeypatch.setattr(gp, "shift_gather_plain",
                        lambda flat, s, dp: flat[s.long()[:, None]
                                                 + torch.arange(dp) + 1])
    with pytest.raises(AssertionError, match="differs from its plain"):
        tgkp.run(b=8, d=20, f=33, e=5000, device="cpu")


# ---------------------------------------------------------- gather_probe

def _strategy_inputs(seed=0, n=300, f=33, b=9, d=20, e=4000):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n + 1, f)).astype(np.float32)
    nbr = rng.integers(0, n + 1, size=(b, d)).astype(np.int32)
    starts = np.sort(rng.integers(0, e - d, size=(b,))).astype(np.int32)
    edge_feats = rng.normal(size=(e + d + 4096, f)).astype(np.float32)
    return table, nbr, starts, edge_feats


def test_row_gathers_equal_jnp():
    table, nbr, _, _ = _strategy_inputs()
    got = tgp.row_gather(torch.from_numpy(table), torch.from_numpy(nbr))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(table)[nbr]))
    got = tgp.row_gather(torch.from_numpy(table).to(torch.bfloat16),
                         torch.from_numpy(nbr))
    want = jnp.asarray(table).astype(jnp.bfloat16)[nbr]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("d", [1, 20, 64])
def test_block_strategies_equal_jnp(d):
    """``block_gather`` against ``lax.gather``, kernel 1's plain path
    against the vmapped ``dynamic_slice``, kernel 2's against the Pallas
    flat block (interpret mode) with the JAX script's bitcasts."""
    f = 33
    _, _, starts, ef = _strategy_inputs(seed=d, f=f, d=d)
    b = starts.shape[0]
    efj, stj = jnp.asarray(ef), jnp.asarray(starts)
    dn = jax.lax.GatherDimensionNumbers(offset_dims=(1, 2),
                                        collapsed_slice_dims=(),
                                        start_index_map=(0,))
    want = np.asarray(jax.lax.gather(efj, stj[:, None], dn,
                                     slice_sizes=(d, f)))
    et, st = torch.from_numpy(ef), torch.from_numpy(starts)
    np.testing.assert_array_equal(tgp.block_gather(et, st, d).numpy(), want)
    vds = jax.vmap(lambda s: jax.lax.dynamic_slice(efj, (s, 0), (d, f)))(stj)
    np.testing.assert_array_equal(np.asarray(vds), want)
    np.testing.assert_array_equal(
        tgp.kernel1_dynamic_slice(et, st, d).numpy(), np.asarray(vds))
    # the JAX script's flat block: padded, bitcast, ragged kernel, bitcast
    df = d * f
    dp = -(-df // 128) * 128
    span = -(-dp // 1024) * 1024 + 1024
    flat_len = ef.shape[0] * f
    need = -(-(flat_len + span) // 1024) * 1024 + span
    flat_i = jax.lax.bitcast_convert_type(
        jnp.pad(efj.reshape(-1), (0, need - flat_len)), jnp.int32)
    raw = ragged_window_gather(flat_i, stj * f, dp, interpret=True)
    block = jax.lax.bitcast_convert_type(raw[:, :df], jnp.float32)
    got = tgp.kernel2_flat_block(et.view(-1).view(torch.int32), st, d, f)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(block).reshape(b, d, f))


def test_gather_probe_script_checks_every_strategy(monkeypatch, capsys):
    """The five strategies on the CPU with the timing faked: each equal to
    the first that computes its values, timed over the JAX script's
    bytes."""
    calls = []
    _fake_timing(monkeypatch, calls)
    res = tgp.run(n=500, f=33, b=37, d=20, e=5000, device="cpu")
    out_bytes = 37 * 20 * 33 * 4
    assert [r["name"] for r in res["rows"]] == [
        "row_gather", "block_gather", "kernel1_dynamic_slice",
        "kernel2_flat_block", "row_gather_bf16"]
    assert [r["checked_against"] for r in res["rows"]] == [
        None, None, "block_gather", "block_gather", "row_gather"]
    assert calls == [out_bytes] * 4 + [out_bytes // 2]
    out = capsys.readouterr().out
    assert out.count("correct: True") == 3


def test_strategy_names_follow_the_jax_script():
    """One port strategy for each JAX one, in its order."""
    src = (ROOT / "benchmarks/gather_probe.py").read_text()
    jax_names = re.findall(r'report\("(\w+)"', src)
    assert jax_names == ["xla_row_gather", "xla_block_gather",
                         "xla_vmap_dynamic_slice", "pallas_flat_block",
                         "xla_row_gather_bf16"]
    data = tgp.probe_data(50, 33, 4, 6, 400, "cpu")
    assert len(tgp.strategies(data, 6)) == len(jax_names)
