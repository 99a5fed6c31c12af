"""The ESRGAN training cell's harness on the CPU: the dense block's growth
formula, the reference step's FLOPs against the program's census, a short
run at a small size (correct), the unchanged-state fault (not correct), the
control one precision down, and the readers of its three metrics.

    python -m pytest portbench/tests/test_pb_esrgan.py -q
"""
from __future__ import annotations

import pytest
import torch

from portbench import flops, run, trace
from portbench.reference import esrgan
from portbench.tools import control_esrgan

WORKLOAD = "train.florida-esrgan"
SMALL = {"train_samples": 40, "config": {"filters": 8, "num_res_blocks": 1,
                                         "hp": {"batch_size": 4}}}
SEED = 2**31 + 29


def test_growth_formula():
    """(64, 32) at 16x16: 122,683,392 FLOP a sample; at growth = filters
    the florida formula, FLOPs and packed bytes alike."""
    assert esrgan.drb_flops_per_sample(64, 32, 16, 16) == 122_683_392
    for f in (8, 16):
        assert esrgan.drb_flops_per_sample(f, f, 16, 16) == flops.drb_flops_per_sample(f, 16, 16)
        assert esrgan.drb_weight_bytes(f, f) == flops.drb_weight_bytes(f, "float32")
    # B=128: three TF32 passes of 15.70 GFLOP at 495 TFLOP/s bound it
    assert esrgan.drb_bound_seconds(128, 64, 32, 16, 16) == pytest.approx(
        3 * 128 * 122_683_392 / 495e12)


def test_reference_step_flops_equal_the_program_census():
    """At a tiny width the ESRGAN reference step counts what the program's
    census counts, up to the critic's GP double backward, which the two
    count alike for both generators: the florida reference's gap to the
    census at the same critic and batch (since the critic's weight terms
    became wgrads, the census no longer counts stock autograd's zero
    convolutions there). The generator's part is counted exactly."""
    from downgan_tpu_torch.utils.flops import train_flop_census

    over = {"config": {"filters": 8, "num_res_blocks": 2, "hp": {"batch_size": 4}}}
    gaps = {}
    for workload, count in ((WORKLOAD, esrgan.reference_train_flops),
                            ("train.florida-rrdb", flops.reference_train_flops)):
        r = run.prepare(workload, 0, 0, False, "cpu", overrides=over)
        config = run.program_config(r.raw, 0)
        census = train_flop_census(config, config.hp.critic_iterations)
        gaps[config.generator_arch] = count(r.raw) - census["flops_per_step"]
    assert gaps["esrgan"] == gaps["rrdb"]
    assert 0 <= gaps["esrgan"] < 0.02 * esrgan.reference_train_flops(
        run.prepare(WORKLOAD, 0, 0, False, "cpu", overrides=over).raw)


def test_published_widths_of_the_cell():
    r = run.prepare(WORKLOAD, 0, 0, False, "cpu")
    spec = esrgan.generator_spec(r.raw)
    assert sum(torch.Size(shape).numel() for _, shape, _ in spec) == 17_068_994
    assert (r.raw["filters"], r.raw["num_res_blocks"], r.raw["generator_arch"]) == \
        (64, 23, "esrgan")
    assert r.raw["hp"]["compute_dtype"] == "float32" and r.raw["hp"]["batch_size"] == 128


def test_a_short_run_is_correct():
    res = run.run_cell(WORKLOAD, SEED, 0.5, False, "cpu", overrides=SMALL)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "train_patches_per_s", "peak_mem_gib"}


def test_an_unchanged_state_is_not_correct(monkeypatch):
    from downgan_tpu_torch.training import state

    monkeypatch.setattr(state.ScheduledAdam, "step", lambda self, closure=None: None)
    res = run.run_cell(WORKLOAD, SEED, 0.5, False, "cpu", overrides=SMALL)
    assert not res["correct"], res["checks"]


def test_the_control_fails_a_number():
    r = run.prepare(WORKLOAD, SEED, 0, False, "cpu", overrides=SMALL)
    readings = dict(control_esrgan.train_readings(r, torch.device("cpu"), only=("control",)))
    limits = r.cell["limits"]
    assert any(readings["control"][k] > limit for k, limit in limits.items()), readings


def _outcome(kernels):
    r = run.prepare(WORKLOAD, 0, 0, False, "cpu")
    tr = trace.Trace(window_s=1.0, kernels=kernels)
    out = run.Outcome(e2e={}, attempted=10, failed=0, peak_bytes=0, checks={},
                      window={"kind": "train", "calls": 10, "seconds": 2.0,
                              "compute_dtype": "float32", "drb_batch": 128}, trace=tr, run=r)
    return out


def test_the_readers():
    """The wide kernel's share by its trace name (which the florida readers'
    pattern does not match), the step's share by the ESRGAN reference's
    FLOPs, and the idle share."""
    wide = "(anonymous namespace)::drb_kernel_wide(float const*, float4 const*, float const*, " \
           "float*, int)"
    out = _outcome([(wide, 0.0, 200.0), (wide, 300.0, 200.0), ("other", 600.0, 100.0)])
    roof = run.load_module("metrics", "drb_roofline_pct.esrgan").read(out)
    assert roof == pytest.approx(100 * esrgan.drb_bound_seconds(128, 64, 32, 16, 16) / 200e-6)
    from portbench.readers import DRB_KERNELS

    assert not trace.Trace(window_s=1.0, kernels=[(wide, 0.0, 1.0)]).matching(
        DRB_KERNELS["float32"])
    idle = run.load_module("metrics", "device_idle_pct.esrgan").read(out)
    assert idle == pytest.approx(100 * (1 - 500e-6))
    mfu = run.load_module("metrics", "train_mfu_pct.esrgan").read(out)
    per_call = esrgan.reference_train_flops(out.run.raw)
    assert mfu == pytest.approx(100 * per_call * 10 / 2.0 / 495e12)
    assert run.load_module("metrics", "drb_roofline_pct.esrgan").read(_outcome([])) is None
