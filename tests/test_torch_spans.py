"""The port's phase spans (``utils/profiling.py::annotate``) and the generate
loop's counters, on the CPU at a tiny size: off, a span enters no
``record_function``; under ``torch.profiler`` a reference step, a fused
round and a generate pass emit exactly the closed list of spans, nested
as documented; ``generate_fields_iter`` counts its chunks and the
caller's time holding them, less a hold across which a profiler
started."""
from __future__ import annotations

import json
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu_torch import inference  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset  # noqa: E402
from downgan_tpu_torch.parallel.dp import device_batches  # noqa: E402
from downgan_tpu_torch.training import trainer as trainer_mod  # noqa: E402
from downgan_tpu_torch.training.state import make_train_state  # noqa: E402
from downgan_tpu_torch.training.wgan import build_fused_round, build_train_step  # noqa: E402
from downgan_tpu_torch.utils import profiling  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
N_DRB = 3 * KW["num_res_blocks"]
# The closed list of the program's spans; drb.backward runs only on the
# card (DRBFunction), where the -m cuda leg of portbench/tests sees it.
PROGRAM_SPANS = {
    "feed.batch", "train.call", "critic.fake", "critic.update", "critic.loss",
    "critic.backward", "critic.adam", "generator.update", "generator.loss",
    "generator.backward", "generator.adam", "metric.pass", "drb.backward", "drb.pack",
    "trainer.accumulate", "trainer.epoch_sync", "generate.load", "generate.h2d",
    "generate.forward", "generate.copy_back", "generate.consumer"}


def _config(schedule):
    return Config(hp=HyperParams(batch_size=2, schedule=schedule,
                                 metrics_to_calculate=("MAE", "MSE", "Wass")), **KW)


def _train_call(schedule):
    """A fresh state and ``go()``: one batch (or round) of the trainer's
    epoch, through ``device_batches``, the step, ``_add`` and the epoch's
    host sync; ``go`` returns the host means."""
    cfg = _config(schedule)
    torch.manual_seed(0)
    state = make_train_state(cfg, "cpu")
    step = (build_fused_round if schedule == "fused" else build_train_step)(
        cfg, state.generator, state.critic)
    g = torch.Generator().manual_seed(1)
    n = 2 * 5 * 2
    ds = DeviceDataset(torch.randn(n, 7, 8, 8, generator=g), torch.randn(n, 2, 64, 64, generator=g))
    perm = ds.epoch_perm(np.random.default_rng(0), 2)

    def go():
        sums = {}
        coarse, fine = next(device_batches(cfg, ds, perm))
        trainer_mod._add(sums, step(state, coarse, fine))
        return trainer_mod._to_host_means(sums, 1)

    return go


def _generate(sleep_s=0.0, n=10, chunk=4):
    cfg = _config("reference")
    torch.manual_seed(0)
    weights = make_train_state(cfg, "cpu").generator.state_dict()
    series = np.random.default_rng(0).standard_normal((n, 8, 8, 7)).astype(np.float32)

    def go():
        blocks = []
        for _, block in inference.generate_fields_iter(cfg, weights, series, chunk_size=chunk,
                                                       device="cpu"):
            time.sleep(sleep_s)
            blocks.append(block)
        return np.concatenate(blocks)

    return go


def _spans(fn, tmp_path):
    """The ``user_annotation`` events of ``fn()`` under the profiler, as
    the Chrome trace holds them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def test_the_flag_is_the_profilers_and_off_enters_nothing(monkeypatch):
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    assert autograd_profiler._is_profiler_enabled is False
    assert profiling.annotate("a") is profiling.annotate("b") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(profiling.annotate("a"), torch.profiler.record_function)
    assert profiling.annotate("a") is profiling._OFF

    want = {s: _train_call(s)() for s in ("reference", "fused")}
    want["generate"] = _generate()()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("train.call") is profiling._OFF
    for s in ("reference", "fused"):
        assert _train_call(s)() == want[s]
    np.testing.assert_array_equal(_generate()(), want["generate"])


def _inside(child, parents):
    s, e = child["ts"], child["ts"] + child["dur"]
    return any(p["tid"] == child["tid"] and p["ts"] <= s and e <= p["ts"] + p["dur"]
               for p in parents)


@pytest.mark.parametrize("schedule", ["reference", "fused"])
def test_a_step_and_a_round_emit_the_closed_list_nested(schedule, tmp_path):
    events = _spans(_train_call(schedule), tmp_path)
    program = [e for e in events if not e["name"].startswith("Optimizer.")]
    counts = Counter(e["name"] for e in program)
    n = 5 if schedule == "fused" else 1  # critic updates in the call
    # a fresh state packs each DRB's weights for the first fake and again
    # after the generator's Adam step, for the metric pass's fresh fake
    assert counts == {"feed.batch": 1, "train.call": 1, "critic.fake": n, "critic.update": n,
                      "critic.loss": n, "critic.backward": n, "critic.adam": n,
                      "generator.update": 1, "generator.loss": 1, "generator.backward": 1,
                      "generator.adam": 1, "metric.pass": 1, "drb.pack": 2 * N_DRB,
                      "trainer.accumulate": 1, "trainer.epoch_sync": 1}
    assert set(counts) <= PROGRAM_SPANS
    by = {name: [e for e in program if e["name"] == name] for name in counts}
    for child, parent in [("critic.fake", "train.call"), ("critic.update", "train.call"),
                          ("generator.update", "train.call"), ("metric.pass", "train.call"),
                          ("critic.loss", "critic.update"), ("critic.backward", "critic.update"),
                          ("critic.adam", "critic.update"),
                          ("generator.loss", "generator.update"),
                          ("generator.backward", "generator.update"),
                          ("generator.adam", "generator.update"), ("drb.pack", "train.call")]:
        assert all(_inside(c, by[parent]) for c in by[child]), (child, parent)
    for outside in ("feed.batch", "trainer.accumulate", "trainer.epoch_sync"):
        assert not any(_inside(c, by["train.call"]) for c in by[outside])


def test_a_generate_pass_emits_its_spans(tmp_path):
    events = _spans(_generate(), tmp_path)
    counts = Counter(e["name"] for e in events)
    chunks = 3  # 10 samples in chunks of 4
    assert counts == {"generate.load": 1, "generate.h2d": chunks, "generate.forward": chunks,
                      "generate.copy_back": chunks, "generate.consumer": chunks,
                      "drb.pack": N_DRB}
    assert set(counts) <= PROGRAM_SPANS
    forwards = [e for e in events if e["name"] == "generate.forward"]
    assert all(_inside(e, forwards) for e in events if e["name"] == "drb.pack")


def test_the_generate_counters_count_chunks_and_the_callers_time():
    loop = inference.generate_fields_iter
    chunks, held = loop.chunks, loop.consumer_s
    _generate(sleep_s=0.0)()
    assert loop.chunks == chunks + 3
    quick = loop.consumer_s - held
    chunks, held = loop.chunks, loop.consumer_s
    _generate(sleep_s=0.05)()
    assert loop.chunks == chunks + 3
    slept = loop.consumer_s - held
    assert 3 * 0.05 <= slept < 3 * 0.05 + 1.0 and quick < 3 * 0.05


def test_a_hold_across_a_profilers_start_is_left_out():
    from torch.profiler import ProfilerActivity, profile

    cfg = _config("reference")
    weights = make_train_state(cfg, "cpu").generator.state_dict()
    series = np.zeros((8, 8, 8, 7), np.float32)
    loop = inference.generate_fields_iter
    it = loop(cfg, weights, series, chunk_size=4, device="cpu")
    next(it)
    held = loop.consumer_s
    time.sleep(0.2)  # the caller starting a profiler, say
    with profile(activities=[ProfilerActivity.CPU]):
        next(it)
    assert loop.consumer_s == held and loop.chunks >= 2
