"""The port's roofline tool against the JAX tool, on the CPU.

- ``vpu_chain_plain`` against ``tools/scan_roofline.py::_vpu_kernel`` run
  through ``pl.pallas_call(..., interpret=True)`` on a small tile, both
  variants: max |diff| <= 1e-6 after 16 steps (fp32, values of order 1;
  the ``exp`` of the two frameworks differ by an ulp). XLA fuses
  ``y * c + d`` into one FMA on the CPU: after 32 steps the plain chain
  that rounds twice a step is 1.9e-6 off (bound 4e-6) and the one that
  rounds once (``fused=True``) stays within 1e-6.
- the step count exactly: c = 0.5, d = 0 gives x * 2^(-16 rounds) bit for
  bit, c = 1, d = 1 gives x + 16 rounds on small integers.
- the floor arithmetic (``roofline.py``) against numbers worked by hand.

On the CPU ``vpu_chain`` takes the plain version; the CUDA kernel is held
against it on the card by ``chip_smoke.py``.
"""

import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mamba_clip_tpu_torch import roofline, scan_roofline
from mamba_clip_tpu_torch.ops import vpu_chain as vc

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))


@pytest.fixture(scope="module")
def jax_tool():
    import scan_roofline as tool  # tools/scan_roofline.py

    return tool


@pytest.mark.parametrize("use_exp", [False, True])
@pytest.mark.parametrize("rounds", [1, 2])
def test_plain_chain_matches_the_pallas_kernel_in_interpret_mode(jax_tool, use_exp, rounds):
    x = np.random.default_rng(0).random((16, 128), np.float32)
    kern = functools.partial(jax_tool._vpu_kernel, rounds=rounds, use_exp=use_exp)
    want = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)(
            jnp.asarray(x)))
    got = vc.vpu_chain(torch.from_numpy(x), rounds, use_exp)  # CPU: the plain version
    assert vc.UNROLL == jax_tool._UNROLL == 16
    assert got.dtype == torch.float32 and got.shape == x.shape
    # XLA's CPU backend contracts y * c + d into one FMA, so the plain chain that
    # rounds twice a step drifts from it by 0.06 ulp-of-1 a step: inside 1e-6 after 16
    # steps, 1.9e-6 after 32. The chain that rounds once a step stays inside 1e-6.
    err = np.abs(got.numpy() - want).max()
    assert err <= (1e-6 if rounds == 1 or use_exp else 4e-6)
    if not use_exp:
        once = vc.vpu_chain_plain(torch.from_numpy(x), rounds, fused=True)
        assert np.abs(once.numpy() - want).max() <= 1e-6
    assert np.abs(got.numpy() - x).max() > 1e-6  # the chain did move the values
    assert vc.vpu_chain.launches == 0


@pytest.mark.parametrize("rounds", [0, 1, 2, 3, 4])
def test_plain_chain_takes_exactly_sixteen_steps_a_round(rounds):
    x = torch.from_numpy(np.random.default_rng(1).random(1000, np.float32) + 0.5)
    assert torch.equal(vc.vpu_chain_plain(x, rounds, False, 0.5, 0.0),
                       x * 2.0 ** (-16 * rounds))
    ints = torch.arange(0, 300, dtype=torch.float32)
    for fused in (False, True):
        assert torch.equal(vc.vpu_chain_plain(ints, rounds, False, 1.0, 1.0, fused=fused),
                           ints + 16 * rounds)
    assert torch.equal(vc.vpu_chain_plain(ints, 9, False, 1.0, 1.0, steps=15), ints + 15)


def test_exp_chain_contracts_and_one_step_fewer_is_visible():
    """After 16 steps the exp chain's spread is about 1e-4 of its start and
    a 15-step chain differs by more than 1e-5 of the largest entry: the gate
    the card's check uses can tell whether every step ran. After 64 steps
    every element sits on the fixed point y = exp(-c y) + d, 0.567."""
    x = torch.from_numpy(np.random.default_rng(2).random(4096, np.float32))
    y16 = vc.vpu_chain_plain(x, 1, True)
    y15 = vc.vpu_chain_plain(x, 0, True, steps=15)
    assert 1e-5 < float(y16.max() - y16.min()) < 1e-3
    assert float((y16 - y15).abs().max() / y15.abs().max()) > 1e-5
    y64 = vc.vpu_chain_plain(x, 4, True)
    assert float(y64.max() - y64.min()) < 1e-6 and abs(float(y64[0]) - 0.5671) < 1e-3


def test_fused_rounding_is_the_single_rounding_of_an_fma():
    """``fused=True`` rounds y * c + d once. Against exact arithmetic in
    numpy's longdouble it is the nearest fp32 value; the unfused chain
    drifts from it by up to 1e-4 relative over 1024 steps at the tool's
    constants (measured 6.1e-5), which is why the card's check holds the
    kernel against the fused version."""
    x = np.random.default_rng(3).random(2048, np.float32)
    c, d = np.float32(vc.C), np.float32(vc.D)
    one = vc.vpu_chain_plain(torch.from_numpy(x), 0, False, steps=1, fused=True).numpy()
    exact = (x.astype(np.longdouble) * np.longdouble(c) + np.longdouble(d)).astype(np.float32)
    assert np.array_equal(one, exact)
    fused = vc.vpu_chain_plain(torch.from_numpy(x), 64, fused=True)
    unfused = vc.vpu_chain_plain(torch.from_numpy(x), 64)
    rel = float((fused - unfused).abs().max() / fused.abs().max())
    assert 1e-6 < rel < 2e-4


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="rounds must be >= 0"):
        vc.vpu_chain(torch.zeros(4), -1)
    with pytest.raises(ValueError, match="no implementation for device"):
        vc.vpu_chain(torch.zeros(4, device="meta"), 1)
    assert vc.vpu_chain(torch.zeros(0), 3).numel() == 0


def test_bounds_against_numbers_worked_by_hand():
    assert (roofline.HBM_BYTES_PER_S, roofline.FP32_FLOPS, roofline.BF16_TC_FLOPS,
            roofline.TF32_TC_FLOPS) == (3.35e12, 67e12, 989.4e12, 494.7e12)
    assert roofline.sfu_peak(132, 1980.0) == 132 * 16 * 1980e6 == 4.18176e12
    assert roofline.fma_peak(132, 1980.0) == 132 * 128 * 1980e6
    # forward: B 2, G 4, L 32, DG 8, N 16, bf16. E = 2048 channel-steps.
    # bytes: u, delta 2*2048*2 + y 4*2048 + B, C 2*(2*4*32*16)*2 + A, D, bias 4*8*18*4
    b = roofline.scan_bound(2, 32, 8, 2, 1e9, hbm_rate=1e10, fp32_rate=1e11)
    assert b["bytes"] == 8192 + 8192 + 16384 + 2304 == 35072
    assert b["flops"] == 9 * 2048 * 16 + 2 * 2048 == 299008
    assert b["exps"] == 2048 * 16 == 32768
    assert b["bytes_ms"] == pytest.approx(35072 / 1e10 * 1e3)
    assert b["flops_ms"] == pytest.approx(299008 / 1e11 * 1e3)
    assert b["exps_ms"] == pytest.approx(32768 / 1e9 * 1e3)
    assert b["bound_ms"] == pytest.approx(b["exps_ms"]) and b["bound_by"] == "operations"
    # a slow memory makes the same work bound by bytes
    b = roofline.scan_bound(2, 32, 8, 2, 1e9, hbm_rate=1e8, fp32_rate=1e11)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(0.35072)
    # backward, in: u, delta 2*2048*2; B, C 2*4096*2; dy 4*2048; hck 4*(2*4*2*8*16);
    # A, D, bias 2304; out: ddelta, du 8*2048; dB, dC 2*4096*4; dA, dD, dbias 2304
    w = roofline.scan_bwd_bound(2, 32, 8, 2, 1e9, hbm_rate=1e10, fp32_rate=1e11)
    assert w["bytes"] == 8192 + 16384 + 8192 + 8192 + 2304 + 16384 + 32768 + 2304 == 94720
    assert w["flops"] == 18 * 2048 * 16 + 10 * 2048 and w["exps"] == 2048 * 19
    # the defaults are the data sheet
    d = roofline.scan_bound(64, 3136, 64, 2, 4.18176e12)
    assert d["bytes_ms"] == pytest.approx(1e3 * d["bytes"] / 3.35e12)
    assert d["flops_ms"] == pytest.approx(1e3 * d["flops"] / 67e12)
    # attention forward, ViT shape: q, k, v, o of 64*197*12*64 bf16; 2 products
    a = roofline.attn_bound(64, 197, 12, 64, 2, False, 4.18176e12)
    assert a["bytes"] == 4 * 64 * 197 * 768 * 2 == 77463552
    assert a["flops"] == 2 * 2 * 64 * 12 * 197 * 197 * 64
    assert a["bound_by"] == "bytes" and a["bound_ms"] == pytest.approx(0.0231, abs=1e-4)
    m = roofline.attn_bound(64, 256, 12, 64, 2, True, 4.18176e12, tensors=6, stats=3,
                            products=4)
    assert m["bytes"] == 6 * 64 * 256 * 768 * 2 + 3 * 64 * 12 * 256 * 4 + 64 * 256 == 153370624


@pytest.mark.parametrize("kind, kw, tf32_ms, fma_ms", [
    ("forward", dict(stats=2), 1.497, 3.674),
    ("dk/dv", dict(tensors=6, stats=3, products=4), 2.986, 7.349),
    ("dq", dict(tensors=5, stats=3, products=3), 2.239, 5.512),
])
def test_fp32_attention_bounds_in_3xtf32(kind, kw, tf32_ms, fma_ms):
    """The fp32 flash bodies' bounds per 12 + 12 launches at batch 64 (the
    ViT's T 197 unmasked, the BERT's T 256 masked; h 12, hd 64, fp32): in
    3xTF32 each product is three TF32 products, so the tensor cores' rate
    is a third of the TF32 peak; beside it the fp32 FMA bound of the same
    work. At T 197 the forward's bytes and operations nearly tie (the
    bytes bound it by 0.3 us); everything else is bound by operations."""
    rows = [(197, False), (256, True)]
    tf32 = [roofline.attn_bound(64, T, 12, 64, 4, masked, 4.18176e12, **kw,
                                tc_rate=roofline.TF32_TC_FLOPS / 3) for T, masked in rows]
    fma = [roofline.attn_bound(64, T, 12, 64, 4, masked, 4.18176e12, **kw,
                               tc_rate=roofline.FP32_FLOPS) for T, masked in rows]
    assert sum(12 * b["bound_ms"] for b in tf32) == pytest.approx(tf32_ms, abs=5e-4)
    assert sum(12 * b["bound_ms"] for b in fma) == pytest.approx(fma_ms, abs=5e-4)
    assert [b["bound_by"] for b in tf32] == (
        ["bytes", "operations"] if kind == "forward" else ["operations", "operations"])
    assert all(b["bound_by"] == "operations" for b in fma)
    assert tf32[1]["flops_ms"] * 494.7 / 3 == pytest.approx(fma[1]["flops_ms"] * 67)


@pytest.mark.parametrize("L, DG, nbytes, bwd_ms, fwd_ms", [
    (3136, 64, 1181782016, 0.35277075104477607, 0.19658794000612181),
    (784, 128, 552411136, 0.1648988465671642, 0.09829397000306091),
    (196, 256, 269828096, 0.08054570029850747, 0.049146985001530454),
    (49, 512, 139018240, 0.041497982089552236, 0.024573492500765227),
    (300, 80, 137999360, 0.04119383880597015, 0.023507805325987143),
])
def test_scan_bounds_at_chunk_16_unchanged(L, DG, nbytes, bwd_ms, fwd_ms):
    """The backward's bound counts hck at the package's ``CHUNK``; at 16 it
    gives, to the digit, the numbers it gave when the 16 was a literal
    (batch 64, bf16, the data sheet's rates, the exp peak of 132 SMs at
    1980 MHz)."""
    from mamba_clip_tpu_torch.ops.selective_scan import CHUNK

    assert CHUNK == 16
    b = roofline.scan_bwd_bound(64, L, DG, 2, 4.18176e12)
    assert b["bytes"] == nbytes and b["bound_ms"] == bwd_ms and b["bound_by"] == "bytes"
    assert roofline.scan_bound(64, L, DG, 2, 4.18176e12)["bound_ms"] == fwd_ms


def test_chip_smoke_shares_the_package_count():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("bound_of", "scan_bound", "scan_bwd_bound", "attn_bound"):
        assert not hasattr(smoke, name), f"chip_smoke.py still defines {name}"
    assert "vpu_chain" in smoke.KERNELS and len(smoke.KERNELS) == 5


def test_tool_floors_and_cpu_rehearsal(tmp_path, capsys):
    times = {"fwd_ms": 0.5, "bwd_ms": 2.0}
    rates = scan_roofline.measured_rates(
        {"exp": {"per_s": 1e9}, "hbm": {"bytes_per_s": 1e10}, "fma": {"per_s": 5e10}})
    assert rates == {"sfu_rate": 1e9, "hbm_rate": 1e10, "fp32_rate": 1e11}
    f = scan_roofline.floors(2, 4, 32, 8, 16, times, rates, "measured")
    assert f["fwd_bound_measured"]["bound_ms"] == pytest.approx(0.032768)
    assert f["fwd_pct_of_measured_bound"] == pytest.approx(100 * 0.032768 / 0.5)
    assert f["bwd_bound_measured"]["exps"] == 2048 * 19
    assert f["bwd_pct_of_measured_bound"] == pytest.approx(
        100 * f["bwd_bound_measured"]["bound_ms"] / 2.0)
    assert [s[1:] for s in scan_roofline.scan_shapes()] == [
        (32, 4, 3136, 64, 16), (32, 4, 784, 128, 16), (32, 4, 196, 256, 16),
        (32, 4, 49, 512, 16)]

    out = scan_roofline.main(["--device", "cpu", "--out", str(tmp_path / "roofline.json")])
    assert json.loads(capsys.readouterr().out) == json.load(open(tmp_path / "roofline.json"))
    assert out["platform"] == "cpu" and "no number here is a device metric" in out["note"]
    assert "card" not in out and out["vpu_chain_launches"] == 0
    assert out["exp_cost_in_fma_slots"] == pytest.approx(
        out["fma"]["per_s"] / out["exp"]["per_s"] - 1)
    (label, m), = out["scan"].items()
    assert m["fwd_ms"] > 0 and m["fwdbwd_ms"] > m["fwd_ms"] and "fwd_bound_datasheet" not in m
    assert m["fwd_achieved_exps_per_s"] == pytest.approx(
        m["fwd_bound_measured"]["exps"] / (m["fwd_ms"] * 1e-3))
