"""The program spans' arithmetic (``spans.py``), on a small synthetic
Chrome trace fed through ``trace.profiled`` under ``spans.capturing``: a
nested span; a launch on another thread inside the main thread's span; a
missing launch event counted as unattributed; an idle gap named by the
innermost open span. The readers read the same values with and without
the span and launch events; the new reader reads None where the program
keeps no counters. The card's legs attribute a generate chunk's DRB
kernels to ``generate.forward`` and the DRB backward's launches, from
autograd's thread, to the generator update.
"""
from __future__ import annotations

import json
import threading

import pytest
import torch

from portbench import run, spans, trace

NEW = {"generate_consumer_ms.gen"}
MAIN = threading.get_native_id()
AUTOGRAD = MAIN + 1
DRB = "void drb_kernel<float, 16, 18>(float const*, float*)"


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _launch(corr, ts, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 5, tid, correlation=corr)


EVENTS = [
    # spans (us): the main thread's step, updates and backwards; two DRB
    # backwards on autograd's thread while the main thread waits in
    # generator.backward; one span still open when the profile ended
    _x("user_annotation", "train.call", 0, 1000),
    _x("user_annotation", "critic.update", 100, 300),
    _x("user_annotation", "critic.backward", 200, 200),
    _x("user_annotation", "generator.update", 500, 400),
    _x("user_annotation", "generator.backward", 600, 300),
    _x("user_annotation", "drb.backward", 650, 50, AUTOGRAD),
    _x("user_annotation", "drb.backward", 750, 50, AUTOGRAD),
    _x("user_annotation", "trainer.accumulate", 1015, 20),
    _x("user_annotation", "generate.consumer", 1200, 40, finished=False),
    # device intervals and their launches
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 30, 7, correlation=1),
    _launch(1, 50),
    _x("kernel", "cudnn::fprop", 160, 100, 7, correlation=2), _launch(2, 150),
    _x("kernel", "cudnn::wgrad", 300, 50, 7, correlation=3), _launch(3, 210),
    _x("kernel", DRB, 670, 50, 7, correlation=4), _launch(4, 660, AUTOGRAD),
    _x("kernel", DRB, 780, 50, 7, correlation=5),
    _x("cuda_driver", "cuLaunchKernel", 760, 5, AUTOGRAD, correlation=5),
    _x("kernel", "elementwise", 960, 20, 7, correlation=6), _launch(6, 950),
    _x("kernel", "no_launch_event", 1000, 10, 7, correlation=7),
    _x("kernel", "outside_spans", 1100, 50, 7, correlation=8), _launch(8, 1090),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1160, 10, 7, correlation=9),
    _x("cuda_runtime", "cudaMemcpyAsync", 1155, 20, correlation=9),
    _x("gpu_user_annotation", "train.call", 60, 920, 7),
    # host operators, as breakdown() names gaps by them
    _x("cpu_op", "aten::item", 80, 90),
    _x("cpu_op", "aten::copy_", 700, 80),
]
SPAN_CATS = ("user_annotation", "cuda_runtime", "cuda_driver")


def _profiled(monkeypatch, events, units=None):
    """``trace.profiled`` over a profiler that exports ``events``, and what
    ``spans.capturing`` kept of it: (Trace, SpanTrace)."""
    class FakeProfile:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with spans.capturing() as got:
        tr = trace.profiled(lambda: dict(units or {"calls": 1}))
    (st,) = got
    return tr, st


def test_capturing_keeps_spans_and_launches(monkeypatch):
    export = torch.profiler.profile.export_chrome_trace
    with spans.capturing():
        assert torch.profiler.profile.export_chrome_trace is not export
    assert torch.profiler.profile.export_chrome_trace is export  # put back on exit
    tr, st = _profiled(monkeypatch, EVENTS)
    assert st.tid == MAIN
    assert [s[0] for s in st.spans] == ["train.call", "critic.update", "critic.backward",
                                        "generator.update", "generator.backward",
                                        "drb.backward", "drb.backward",
                                        "trainer.accumulate"]  # the open one left out
    assert st.spans[5] == ("drb.backward", 650.0, 50.0, AUTOGRAD)
    assert st.launch_us == [50.0, 150.0, 210.0, 660.0, 760.0, 950.0, None, 1090.0, 1155.0]
    assert sorted(st.device) == sorted(tr.device)


def test_capturing_reads_a_real_profile_of_the_programs_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from downgan_tpu_torch.utils.profiling import annotate

    with spans.capturing() as got:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with annotate("train.call"):
                with annotate("critic.update"):
                    torch.ones(3).add_(1)
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
    (st,) = got
    assert st.tid == MAIN
    assert [(n, tid) for n, _, _, tid in st.spans] == [("train.call", MAIN),
                                                       ("critic.update", MAIN)]
    outer, inner = st.spans
    assert outer[1] <= inner[1] and inner[1] + inner[2] <= outer[1] + outer[2]


def test_device_time_follows_launches_on_any_thread(monkeypatch):
    _, tr = _profiled(monkeypatch, EVENTS)
    # nested: critic.backward's launch (210) counts for critic.update too
    assert spans.device_us(tr, "critic.update") == 150.0
    assert spans.device_us(tr, "critic.backward") == 50.0
    # launched on autograd's thread inside the main thread's span
    assert spans.device_us(tr, "generator.update") == 100.0
    assert spans.device_us(tr, "drb.backward") == 100.0
    assert spans.device_ms_per(tr, "drb.backward", per="generator.update") == 0.1
    assert spans.device_ms_per(tr, "drb.backward") == 0.05
    # the copy and every launched kernel but the last; not the one without a launch
    assert spans.device_us(tr, "train.call") == 300.0
    assert spans.host_ms(tr, "train.call") == 1.0
    assert spans.device_us(tr, "metric.pass") is None
    assert spans.device_ms_per(None, "train.call") is None


def test_idle_gaps_go_to_the_innermost_span_on_the_calling_thread(monkeypatch):
    _, tr = _profiled(monkeypatch, EVENTS)
    assert spans.gaps(tr) == [(90, 160), (260, 300), (350, 670), (720, 780), (830, 960),
                              (980, 1000), (1010, 1100), (1150, 1160)]
    # 750: drb.backward is open on autograd's thread, the main thread waits
    assert spans.innermost(tr, 750) == "generator.backward"
    assert spans.innermost(tr, 510) == "generator.update"
    assert spans.innermost(tr, 1055) is None
    rows = {r["span"]: r for r in spans.table(tr)}
    assert rows["critic.update"]["idle_self_ms"] == pytest.approx(0.070)
    assert rows["critic.backward"]["idle_self_ms"] == pytest.approx(0.040)
    assert rows["generator.backward"]["idle_self_ms"] == pytest.approx(0.060 + 0.130)
    assert rows["train.call"]["idle_self_ms"] == pytest.approx(0.020)
    assert rows["train.call"]["idle_ms"] == pytest.approx(0.640)
    assert rows["drb.backward"]["idle_ms"] == pytest.approx(0.060)  # the gap at 750, any thread
    assert rows["train.call"]["host_self_ms"] == pytest.approx(0.300)
    assert rows["critic.update"]["host_self_ms"] == pytest.approx(0.100)
    assert rows["drb.backward"]["count"] == 2
    cover = spans.coverage(tr)
    assert cover["busy_ms"] == pytest.approx(0.370)
    assert cover["busy_attributed"] == pytest.approx(300 / 370)
    assert cover["busy_missing_launch"] == pytest.approx(10 / 370)
    assert cover["busy_outside_spans"] == pytest.approx(60 / 370)
    assert cover["idle_gaps_named"] == pytest.approx(640 / 740)
    # time against time: the gaps inside train.call whole, 20 us of the gap
    # (1010, 1100) that trainer.accumulate covers off its midpoint
    assert cover["idle_under_span"] == pytest.approx(660 / 740)


def _outcome(tr, workload, kind):
    r = run.prepare(workload, 1, 1.0, True, "cpu")
    window = {"kind": kind, "seconds": 2.0, "compute_dtype": r.raw["hp"]["compute_dtype"],
              "drb_batch": 128, "calls": 10, "chunks": 10, "patches": 1500}
    out = run.Outcome(e2e={}, attempted=10, failed=0, peak_bytes=0, checks={}, window=window,
                      trace=tr, run=r)
    out.memo.update(train_flops=7e11, gen_flops=4e9)  # the yardstick's count is not at issue
    return out


CELLS = {"train.florida-rrdb": "train", "train.florida-rrdb-tuned": "train",
         "generate.florida-rrdb": "generate"}


def test_existing_readers_and_the_breakdown_read_the_same(monkeypatch):
    bench = run.load_benchmark()
    with_spans, _ = _profiled(monkeypatch, EVENTS, {"calls": 5, "chunks": 5})
    plain, bare = _profiled(monkeypatch, [e for e in EVENTS if e["cat"] not in SPAN_CATS],
                            {"calls": 5, "chunks": 5})
    assert bare.spans == [] and set(bare.launch_us) == {None}
    for tr in (with_spans, plain):
        tr.window_s = 0.002
    assert with_spans.breakdown() == plain.breakdown()
    assert with_spans.busy_s() == plain.busy_s()
    assert (with_spans.kernels, with_spans.copies, with_spans.host_ops) == \
        (plain.kernels, plain.copies, plain.host_ops)
    read = 0
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            continue
        for w in m["workloads"]:
            got = [run.load_module("metrics", m["name"]).read(_outcome(tr, w, CELLS[w]))
                   for tr in (with_spans, plain)]
            assert repr(got[0]) == repr(got[1]), m["name"]
            read += got[0] is not None
    assert read >= 8  # the device readers found the synthetic kernels and copies


def test_the_new_reader_reads_none_without_the_programs_counters(monkeypatch):
    from downgan_tpu_torch import inference

    bench = run.load_benchmark()
    new = [m for m in bench["per_layer"] if m["name"] in NEW]
    assert {m["name"] for m in new} == NEW and bench["per_layer"][-len(NEW):] == new
    plain, _ = _profiled(monkeypatch, [e for e in EVENTS if e["cat"] not in SPAN_CATS])
    loop = inference.generate_fields_iter
    monkeypatch.delattr(loop, "chunks")  # as the program before its counters
    monkeypatch.delattr(loop, "consumer_s")
    for m in new:
        (w,) = m["workloads"]
        reader = run.load_module("metrics", m["name"]).read
        assert reader(_outcome(plain, w, CELLS[w])) is None, m["name"]
        assert reader(_outcome(None, w, CELLS[w])) is None, m["name"]
    monkeypatch.setattr(loop, "chunks", 4, raising=False)
    monkeypatch.setattr(loop, "consumer_s", 0.02, raising=False)
    reader = run.load_module("metrics", "generate_consumer_ms.gen").read
    assert reader(_outcome(None, "generate.florida-rrdb", "generate")) == pytest.approx(5.0)
    assert reader(_outcome(None, "train.florida-rrdb", "train")) is None


def test_the_phases_read_their_spans(monkeypatch):
    _, with_spans = _profiled(monkeypatch, EVENTS)
    assert spans.phases(with_spans) == {
        "critic_update_ms": 0.15, "generator_update_ms": 0.1, "metric_pass_ms": None,
        "drb_backward_ms": 0.1, "host_call_ms": 1.0, "generate_forward_ms": None}
    _, bare = _profiled(monkeypatch, [e for e in EVENTS if e["cat"] not in SPAN_CATS])
    assert set(spans.phases(bare).values()) == {None}


KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _in(tr, name, launch):
    return any(s <= launch <= s + d for n, s, d, _ in tr.spans if n == name)


@pytest.mark.cuda
def test_a_generate_chunks_drb_kernels_go_to_generate_forward():
    import numpy as np

    from downgan_tpu_torch import inference
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.training.state import make_generator

    dev = _card()
    cfg = Config(**KW)
    weights = make_generator(cfg, "cpu").state_dict()
    series = np.random.default_rng(0).standard_normal((8, 8, 8, 7)).astype(np.float32)
    list(inference.generate_fields_iter(cfg, weights, series, chunk_size=4, device=dev))  # warm

    def two_chunks():
        list(inference.generate_fields_iter(cfg, weights, series, chunk_size=4, device=dev))
        return {"chunks": 2}

    with spans.capturing() as got:
        trace.profiled(two_chunks)
    (tr,) = got
    drb = [t for (n, _, _), t in zip(tr.device, tr.launch_us) if "drb_kernel" in n]
    assert len(drb) == 2 * 3 * KW["num_res_blocks"]
    assert all(t is not None and _in(tr, "generate.forward", t) for t in drb)
    assert spans.device_ms_per(tr, "generate.forward") > 0
    assert spans.coverage(tr)["busy_missing_launch"] == 0


@pytest.mark.cuda
def test_the_drb_backward_runs_on_autograds_thread_inside_the_generator_update():
    from downgan_tpu_torch.config.config import Config, HyperParams
    from downgan_tpu_torch.training.state import make_train_state
    from downgan_tpu_torch.training.wgan import build_train_step

    dev = _card()
    cfg = Config(hp=HyperParams(batch_size=4, metrics_to_calculate=("MAE", "Wass")), **KW)
    state = make_train_state(cfg, dev)
    step = build_train_step(cfg, state.generator, state.critic)
    coarse = torch.randn(4, 7, 8, 8, device=dev)
    fine = torch.randn(4, 2, 64, 64, device=dev)
    for _ in range(5):  # warm: step 5 is the next generator update
        step(state, coarse, fine)

    def one_step():
        step(state, coarse, fine)
        return {"calls": 1}

    with spans.capturing() as got:
        trace.profiled(one_step)
    (tr,) = got
    backward = [s for s in tr.spans if s[0] == "drb.backward"]
    assert len(backward) == 3 * KW["num_res_blocks"]
    assert {tid for *_, tid in backward} != {tr.tid}  # autograd's device thread
    assert all(_in(tr, "generator.backward", s) for _, s, _, _ in backward)
    assert 0 < spans.device_us(tr, "drb.backward") <= spans.device_us(tr, "generator.update")
    cover = spans.coverage(tr)
    assert cover["busy_attributed"] > 0.99 and cover["busy_missing_launch"] == 0
