"""What decides ``correct``, driven through whole runs on the CPU at a small
size: a sound run is correct; a run with the timed path broken underneath
is not (a step that leaves the state unchanged, half of each batch left
out, an answer altered where it is produced); and the control, the
reference one precision below the configuration's put in the program's
place, fails at least one of the cell's numbers. The card's leg runs one
short real cell.
"""
from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tools import control

SMALL = {"config": {"num_res_blocks": 1, "hp": {"batch_size": 4}}}
CELLS = {
    "train.florida-rrdb": {"train_samples": 40},
    # bf16 at this size on the CPU (convs emulated in fp32 on bf16 values,
    # batch 8, one RRDB) reads grad1_diff 0.033-0.053 where the cell's own
    # size on the card reads 0.015-0.021: the CPU run is held to limits
    # read at its own size (the control reads 0.125-0.166 there, half the
    # batch 0.16-0.25), not to the card's.
    "train.florida-rrdb-tuned": {"train_samples": 160,
                                 "config": {"num_res_blocks": 1, "hp": {"batch_size": 8}},
                                 "limits": {"loss_gap": 2e-3, "metric_gap": 0.3,
                                            "field_gap": 0.015, "grad1_diff": 0.08,
                                            "delta_diff": 0.33}},
    "generate.florida-rrdb": {"series_samples": 40, "chunk_size": 16},
}
SEED = 2**31 + 17


def small(workload):
    return {**SMALL, **CELLS[workload]}


def cpu_run(workload, seed=SEED):
    return run.run_cell(workload, seed, 0.5, False, "cpu", overrides=small(workload))


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct(workload):
    res = cpu_run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def _frozen_adam(monkeypatch):
    from downgan_tpu_torch.training import state

    monkeypatch.setattr(state.ScheduledAdam, "step", lambda self, closure=None: None)


def _half_batches(monkeypatch):
    from downgan_tpu_torch.parallel import dp

    whole = dp.device_batches

    def half(config, ds, perm, *a):
        for coarse, fine in whole(config, ds, perm, *a):
            axis = 1 if coarse.dim() == 5 else 0
            n = coarse.shape[axis] // 2
            yield coarse.narrow(axis, 0, n), fine.narrow(axis, 0, n)

    monkeypatch.setattr(dp, "device_batches", half)


def _altered_chunks(monkeypatch):
    from downgan_tpu_torch import inference

    chunks = inference._chunks

    def altered(*a, **k):
        for start, block in chunks(*a, **k):
            block = block.copy()
            block.flat[0] += 1.0
            yield start, block

    monkeypatch.setattr(inference, "_chunks", altered)


FAULTS = [("train.florida-rrdb", _frozen_adam), ("train.florida-rrdb", _half_batches),
          ("train.florida-rrdb-tuned", _frozen_adam), ("train.florida-rrdb-tuned", _half_batches),
          ("generate.florida-rrdb", _altered_chunks)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__.strip('_')}"
                                                        for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_fails_a_number(workload):
    r = run.prepare(workload, SEED, 0, False, "cpu", overrides=small(workload))
    dev = torch.device("cpu")
    readings = dict(control.train_readings(r, dev) if workload.startswith("train")
                    else control.answer_readings(r, dev, patches=48))
    limits = r.cell["limits"]
    assert any(readings["control"][k] > limit for k, limit in limits.items()), readings
    assert readings["control"] != {k: 0.0 for k in limits}


def test_the_control_rounds_its_operands():
    from portbench.reference import nets

    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, 300.0, -0.07])
    tf32 = nets.lower(x, "tf32")
    assert tf32[0] == 1.0 and tf32[1] == x[1] and tf32[2] == 300.0
    fp8 = nets.lower(x, "fp8")  # e4m3, the largest magnitude scaled to 448
    assert fp8[2] == 300.0 and not torch.equal(fp8, x)
    assert torch.all((fp8 - x).abs() <= 2.0 ** -4 * x.abs())


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run.run_cell("generate.florida-rrdb", SEED, 2.0, False, "cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["metrics"]["peak_mem_gib"]["value"] > 0
