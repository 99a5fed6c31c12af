"""Profiling, anomaly detection and the train-step measurement of ``cli
profile`` and ``cli tune`` (counterpart of ``downgan_tpu/utils/profiling.py``
and of the measuring half of ``downgan_tpu/bench.py``).

* :func:`trace`: ``torch.profiler`` over the CPU and, with a card, CUDA
  activities, writing a Chrome trace (``<logdir>/*.pt.trace.json``) with
  ``tensorboard_trace_handler``;
* :func:`annotate`: the port's one span primitive, a named span in that
  trace (``record_function``) while a profiler runs, a shared null context
  otherwise. The program's phase spans (the train step's and fused
  round's updates, the DRB recompute backward, the feed, the trainer's
  epoch sums, the generate loop) are all ``annotate`` spans;
* :func:`detect_anomalies`: scoped ``torch.autograd`` anomaly mode with its
  NaN check, which raises when a backward function returns NaN, plus
  :func:`check_finite` on each step's outputs, which raises
  ``FloatingPointError`` on a NaN or Inf that a forward produced (the JAX
  package's ``jax_debug_nans`` stops on both; torch's anomaly mode checks
  backward results only). Both are off again after the block;
* :func:`device_memory_stats`: the card's allocator statistics, ``{}`` on
  the CPU (as the JAX package returns on its CPU backend);
* :func:`measure_train` and :func:`measure_infer`: a warm-up step, then
  ``reps`` timed windows of ``steps`` train steps (or fused rounds, or
  generator forwards) on synthetic data from a numpy seed, timed with CUDA
  events on the card and the host clock on the CPU, with the FLOP census
  (``utils/flops.py``) of the window and the achieved share of the card's
  peak.

``python -m downgan_tpu_torch.utils.profiling --config C --batch B ...``
measures one candidate of ``cli tune`` in its own process and prints its
record as one JSON line (:func:`main`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time
from typing import Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.autograd.profiler as autograd_profiler


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``logdir`` as a Chrome trace (open it in
    TensorBoard's profiler plugin, ``chrome://tracing`` or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


_OFF = contextlib.nullcontext()


def spans_on() -> bool:
    """Whether a ``torch.profiler`` session runs, so :func:`annotate`
    records: ``torch.autograd.profiler._is_profiler_enabled``, set while
    any profile is running, on every thread."""
    return autograd_profiler._is_profiler_enabled


def annotate(name: str):
    """The port's span: a named interval in the profiler's timeline, on the
    clock of the device's kernels and copies, its parent the span enclosing
    it on its thread. On only while a ``torch.profiler`` session runs (any
    session: ``cli profile``'s trace, a benchmark's traced window): then it
    is a ``record_function`` and lands in the Chrome trace as a
    ``user_annotation`` event. Off, it costs one flag check and returns one
    shared null context, entering nothing and allocating nothing."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def check_finite(outputs, what: str = "step") -> None:
    """Raise ``FloatingPointError`` when a tensor in ``outputs`` (a tensor or
    a mapping of them) holds a NaN or Inf."""
    items = outputs.items() if isinstance(outputs, Mapping) else [("output", outputs)]
    bad = sorted(k for k, v in items if not bool(torch.isfinite(v).all()))
    if bad:
        raise FloatingPointError(f"non-finite values in the {what}'s {', '.join(bad)}")


@contextlib.contextmanager
def detect_anomalies() -> Iterator[Callable[..., None]]:
    """Anomaly mode with its NaN check for the block (a backward that
    returns NaN raises, naming the forward op that made it); yields
    :func:`check_finite` for the step's outputs. The previous setting is
    restored after the block."""
    previous = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield check_finite
    finally:
        torch.autograd.set_detect_anomaly(*previous)


def device_memory_stats(device: str | torch.device = "cuda") -> Dict[str, int]:
    """The allocator's bytes on a card (in use, peak, reserved, the card's
    total) under the JAX package's key names; ``{}`` off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "num_allocs": int(s.get("allocation.all.allocated", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory)}


def _timed(device: torch.device, run: Callable[[], None]) -> float:
    """Seconds ``run()`` takes: CUDA events on a card, the host clock to the
    end of ``run`` on the CPU (where every op is synchronous)."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _windows(device, steps, reps, run_once, window, check) -> list:
    """``reps`` timed windows of ``steps`` calls of ``run_once`` inside one
    ``window()`` context; ``check`` (if any) sees each call's outputs."""
    times = []
    with window():
        for _ in range(reps):
            def run():
                for _ in range(steps):
                    out = run_once()
                    if check is not None:
                        check(out)
            times.append(_timed(device, run))
    return times


def measure_train(config, steps: int, reps: int = 1, device: str | torch.device = "cuda",
                  seed: int = 0, window: Callable = contextlib.nullcontext,
                  check: Optional[Callable] = None, census: bool = True) -> dict:
    """Time ``config``'s train step: one warm-up step (or fused round), then
    ``reps`` windows of ``steps`` steps, each window timed whole; returns
    the record (the JAX ``bench.py`` keys ``tune`` reads and more):
    ``metric`` (``wgan_gp_train_patches_per_sec_b{B}_{dtype}`` and the
    JAX package's suffixes), ``value``/``aggregate_patches_per_sec``
    (training patches a second over the median window: a fused round is
    ``critic_iterations x B`` patches), ``unit``, ``n_chips``,
    ``rep_times_s``, ``ms_per_step``, ``generator_forwards`` and
    ``drb_launches`` (the DRB kernel's, 48 a forward on the card, 0 on the
    CPU; warm-up included), the FLOP census of the timed steps (``flops_per_step``,
    ``census``), ``achieved_tflops`` and ``mfu_vs_peak`` against
    ``peak_tflops`` (``utils/flops.py::H100_PEAK_TFLOPS`` of the compute
    dtype; on the CPU null), and ``device``. ``window`` is entered around
    the timed steps (``cli profile``'s trace, which then carries the
    program's phase spans: ``train.call``, ``critic.update``,
    ``generator.update``, ``metric.pass``, ``drb.backward`` and their
    parts, see :func:`annotate`); ``check`` sees each step's metrics."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.state import make_train_state, resolve_device
    from downgan_tpu_torch.training.wgan import build_fused_round, build_train_step

    if steps < 1 or reps < 1:
        raise ValueError("steps and reps must be >= 1")
    dev = resolve_device(device)
    hp = config.hp
    fused = hp.schedule == "fused"
    n_lead = hp.critic_iterations if fused else 1
    b = hp.batch_size
    cs, fs = config.coarse_size, config.fine_size
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((n_lead * b, config.n_covariates, cs, cs)).astype(np.float32)
    fine = rng.standard_normal((n_lead * b, config.n_predictands, fs, fs)).astype(np.float32)
    coarse, fine = torch.from_numpy(coarse).to(dev), torch.from_numpy(fine).to(dev)
    if fused:
        coarse = coarse.reshape(n_lead, b, *coarse.shape[1:])
        fine = fine.reshape(n_lead, b, *fine.shape[1:])
    state = make_train_state(config, dev)
    step_fn = (build_fused_round if fused else build_train_step)(
        config, state.generator, state.critic)

    def run_once():
        return step_fn(state, coarse, fine)

    launches = drb_forward.launches
    run_once()  # warm-up: cuDNN's algorithm choice, the kernel's build and load
    _sync(dev)
    start = state.step
    times = _windows(dev, steps, reps, run_once, window, check)
    median = statistics.median(times)
    pps = steps * n_lead * b / median
    record = _record(config, dev, "train", steps, reps, times, pps)
    record.update(generator_forwards=sum(step_fn.forwards.values()),
                  drb_launches=drb_forward.launches - launches, ms_per_step=median / steps * 1e3)
    if census:
        from downgan_tpu_torch.utils.flops import train_flop_census

        c = train_flop_census(config, steps * reps, start_step=start)
        record.update(_perf(config, dev, c["total_flops"] / reps, median),
                      census=c["pieces"], flops_per_step=c["flops_per_step"])
    return record


def measure_infer(config, steps: int, reps: int = 1, device: str | torch.device = "cuda",
                  seed: int = 0, window: Callable = contextlib.nullcontext,
                  check: Optional[Callable] = None) -> dict:
    """Time the generator forward as served: batch ``hp.batch_size`` of
    seeded covariates, a stochastic generator's fixed latent appended
    (``wgan.py::fixed_latent``); one warm-up forward, then ``reps`` windows
    of ``steps`` forwards. The record is :func:`measure_train`'s without the
    census."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.state import make_generator, resolve_device
    from downgan_tpu_torch.training.wgan import fixed_latent

    if steps < 1 or reps < 1:
        raise ValueError("steps and reps must be >= 1")
    dev = resolve_device(device)
    b, cs = config.hp.batch_size, config.coarse_size
    rng = np.random.default_rng(seed)
    coarse = rng.standard_normal((b, cs, cs, config.n_covariates)).astype(np.float32)
    if config.noise_channels:
        coarse = np.concatenate([coarse, fixed_latent(config, (b, cs, cs, config.noise_channels))],
                                axis=-1)
    g_in = torch.from_numpy(coarse).to(dev).permute(0, 3, 1, 2).contiguous()
    gen = make_generator(config, dev)

    @torch.no_grad()
    def run_once():
        return gen(g_in)

    launches = drb_forward.launches
    run_once()
    _sync(dev)
    times = _windows(dev, steps, reps, run_once, window, check)
    record = _record(config, dev, "infer", steps, reps, times,
                     steps * b / statistics.median(times))
    record.update(generator_forwards=1 + steps * reps, drb_launches=drb_forward.launches - launches,
                  ms_per_step=statistics.median(times) / steps * 1e3)
    return record


def _metric_name(config, mode: str) -> str:
    hp = config.hp
    if mode == "infer":
        return f"generator_patches_per_sec_b{hp.batch_size}_{hp.compute_dtype}"
    return (f"wgan_gp_train_patches_per_sec_b{hp.batch_size}_{hp.compute_dtype}"
            + ("_fused" if hp.schedule == "fused" else "")
            + ("_reusefake" if hp.metrics_reuse_fake else "")
            + ("_fusedcritic" if hp.fused_critic_pass else "")
            + (f"_accum{hp.grad_accum}" if hp.grad_accum > 1 else "")
            + ("_augment" if hp.augment_flips else ""))


def _record(config, dev: torch.device, mode: str, steps: int, reps: int, times: list,
            pps: float) -> dict:
    hp = config.hp
    return {"metric": _metric_name(config, mode), "value": pps, "unit": "patches/sec/chip",
            "aggregate_patches_per_sec": pps, "n_chips": 1, "mode": mode,
            "batch": hp.batch_size, "dtype": hp.compute_dtype,
            "schedule": hp.schedule if mode == "train" else None,
            "grad_accum": hp.grad_accum, "steps": steps, "reps": reps,
            "rep_times_s": times, "steps_per_s": steps / statistics.median(times),
            "device": _device_name(dev)}


def _perf(config, dev: torch.device, flops_per_rep: float, median_s: float) -> dict:
    """Achieved TFLOP/s of a window and its share of the card's peak for the
    compute dtype (no peak off the card)."""
    from downgan_tpu_torch.utils.flops import H100_PEAK_TFLOPS

    achieved = flops_per_rep / median_s / 1e12
    peak = H100_PEAK_TFLOPS[config.hp.compute_dtype] if dev.type == "cuda" else None
    return {"achieved_tflops": achieved, "peak_tflops": peak,
            "peak_of": (f"H100 dense {config.hp.compute_dtype}"
                        + (" (TF32 off, outside the tensor cores)"
                           if config.hp.compute_dtype == "float32" else "")
                        if peak else None),
            "mfu_vs_peak": achieved / peak if peak else None}


def smoke_config(config):
    """``tune --smoke``'s harness-check model, as the JAX package's: a tiny
    network (8 filters, 1 RRDB, 8 -> 32) and metrics that work at 32 px."""
    return config.replace(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
                          hp=dataclasses.replace(config.hp,
                                                 metrics_to_calculate=("MAE", "MSE", "Wass")))


def candidate_config(config, batch: int, dtype: str, schedule: str, grad_accum: int = 1,
                     reuse_fake: bool = False, fused_critic: bool = False):
    """``config`` with one ``tune`` candidate's settings."""
    return config.replace(hp=dataclasses.replace(
        config.hp, batch_size=batch, compute_dtype=dtype, schedule=schedule,
        grad_accum=grad_accum, metrics_reuse_fake=reuse_fake, fused_critic_pass=fused_critic))


def main(argv=None) -> dict:
    """Measure one ``tune`` candidate and print its record as one JSON line."""
    from downgan_tpu_torch.config.config import Config

    ap = argparse.ArgumentParser(prog="python -m downgan_tpu_torch.utils.profiling")
    ap.add_argument("--config", default=None, help="Base config JSON (default: florida).")
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), required=True)
    ap.add_argument("--schedule", choices=("reference", "fused"), default="reference")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reuse-fake", action="store_true")
    ap.add_argument("--fused-critic", action="store_true")
    ap.add_argument("--steps", type=int, default=30, help="Steps (or rounds) a timed window.")
    ap.add_argument("--reps", type=int, default=3, help="Timed windows; the median counts.")
    ap.add_argument("--smoke", action="store_true", help="The tiny harness-check model.")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    else:
        config = Config()
    if args.smoke:
        config = smoke_config(config)
    config = candidate_config(config, args.batch, args.dtype, args.schedule, args.grad_accum,
                              args.reuse_fake, args.fused_critic)
    if torch.device(args.device).type == "cuda":
        # fp32 computes in fp32 (TF32 off), as the CLI's train and serve do.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    record = measure_train(config, args.steps, args.reps, args.device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
