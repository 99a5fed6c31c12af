"""Batch-generation traffic: ``inference.generate_fields_iter`` over a long
covariate series, again and again, as ``cli generate`` runs it.

Set-up makes the series in host memory from the seed (``series_samples``
NHWC covariates of the configuration's shapes, made on the device and
copied back) and the generator's weights on the device, then warms the
path with one call over the series' first two chunks.

The window calls ``generate_fields_iter(config, weights, series)`` (it
loads the generator from the weights on every call, as each `generate`
job does) and consumes each (start, block) as the streamed NetCDF writer
would, without a file: the block is read whole once, for the check that
it is finite; a block that is not counts as a failed chunk. Blocks are
not kept. The rate, ``gen_patches_per_s`` (read per layer as
``gen_patches_per_s.loop`` from ``window``), is the patches copied back to
host memory over the whole window, which ends after the chunk in flight
when ``--seconds`` have passed. ``--trace 1`` profiles ``trace_chunks``
more chunks.

The answers checked: ``sample_chunks`` blocks of the window, drawn from
the seed by reservoir sampling over every chunk of the window, plus the
ragged last chunk of the first pass over the series; each is held against
the reference generator over the same covariates.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, inputs, trace
from portbench.reference import nets
from portbench.run import Marks, Outcome, Run


def run(r: Run) -> Outcome:
    from downgan_tpu_torch import inference

    config = r.config
    if config.hp.compute_dtype == "float32":  # as `cli generate` sets
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(r.device)
    chunk = r.cell["chunk_size"]
    series = inputs.covariate_series(r.raw, r.cell["series_samples"], r.seed, dev)
    g_w, _ = inputs.network_weights(r.raw, r.seed, dev)
    r.phase("series made")

    def blocks():
        while True:
            yield from inference.generate_fields_iter(config, g_w, series, chunk_size=chunk,
                                                      device=dev)

    for _ in inference.generate_fields_iter(config, g_w, series[:2 * chunk], chunk_size=chunk,
                                            device=dev):
        pass
    r.mark_setup_done()

    rng = np.random.default_rng((r.seed, 7))
    k = r.cell["sample_chunks"]
    kept, tail = [], None
    last_start = (len(series) - 1) // chunk * chunk
    failed = chunks = patches = 0
    feed = blocks()
    marks = Marks(dev)
    t0 = time.perf_counter()
    while True:
        start, block = next(feed)
        marks.mark()
        if not np.isfinite(block).all():
            failed += 1
        if chunks < k:
            kept.append((start, block))
        elif rng.integers(0, chunks + 1) < k:
            kept[rng.integers(0, k)] = (start, block)
        if start == last_start and tail is None:
            tail = (start, block)
        chunks += 1
        patches += block.shape[0]
        if time.perf_counter() - t0 >= r.seconds:
            break
    elapsed = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    r.say(marks.summary(chunk, "chunk"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    window = {"chunks": chunks, "patches": patches, "seconds": elapsed,
              "compute_dtype": config.hp.compute_dtype, "drb_batch": chunk, "kind": "generate"}

    profiled = None
    if r.trace:
        n = r.cell["trace_chunks"]

        def traced():
            for _ in range(n):
                next(feed)
            return {"chunks": n}

        profiled = trace.profiled(traced)
    del feed

    answers = kept + ([tail] if tail is not None else [])
    checks = {"answer_gap": compare.answer_gap(
        (block, out) for (_, block), out in zip(answers, reference_blocks(
            r.raw, g_w, series, [(s, b.shape[0]) for s, b in answers], dev)))}
    if len(answers) < min(k, chunks):
        checks["answer_gap"] = float("inf")
    return Outcome(e2e={"gen_patches_per_s": patches / elapsed}, attempted=chunks,
                   failed=failed, peak_bytes=peak, checks=checks, window=window,
                   trace=profiled)


@torch.no_grad()
def reference_blocks(cfg: dict, g_w, series: np.ndarray, spans, dev, mode: str = "fp32"):
    """The reference generator's NHWC fields for each (start, n) of ``series``."""
    out = []
    with nets.arithmetic(mode):
        for start, n in spans:
            x = torch.from_numpy(series[start:start + n]).to(dev).permute(0, 3, 1, 2)
            out.append(nets.generator(g_w, x, cfg, mode).permute(0, 2, 3, 1).cpu().numpy())
    return out
