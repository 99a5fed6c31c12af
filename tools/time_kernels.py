#!/usr/bin/env python3
"""Time each kernel of ``downgan_tpu_torch/ops/cuda/drb.cu`` alone on one CUDA
card, beside its library yardstick and the benchmark's bound, for this
checkout or for another checkout of the port (for example a parent commit
unpacked with ``git archive``).

    python3 tools/time_kernels.py [--root DIR]

Builds the checkout's ``drb.cu`` (into that checkout's ``build/``) and
times, with CUDA events over 50 launches after a warm-up, fp32 with TF32
off:

* ``drb_kernel`` at B=150 (the serving chunk), the domain band (8, 16, 32,
  112) and B=128 (training), beside ``cudnn_chain``, the same block as five
  cuDNN convolutions (checked against the plain twin first);
* ``drb_kernel_bf16`` at the same shapes and B=132 (one sample per SM of an
  H100 SXM), beside ``cudnn_chain`` in bf16;
* ``drb_kernel_wide`` (ESRGAN's block: 64 features, growth 32, slope 0.2) at
  B=128, beside ``cudnn_chain`` at that block;
* ``drb_backward_kernel`` and its reduction ``drb_grad_reduce`` at B=128,
  one call of ``drb_backward_kernel``, beside ``drb_backward``, the cuDNN
  recompute that every other block's backward runs;
* ``drb_backward_kernel_wide`` and its reduction ``drb_grad_reduce_wide``
  (ESRGAN's block) at B=128, one call of ``drb_backward_kernel_wide``,
  beside ``drb_backward`` at that block, the cuDNN recompute it replaced.

The bounds are the benchmark's, and always this checkout's, so that two
checkouts are timed against one yardstick: ``portbench.flops.
drb_bound_seconds`` for the florida blocks (the FLOPs at the TF32 or bf16
peak, or the bytes at the memory rate), ``portbench.reference.esrgan.
drb_bound_seconds`` for the wide block (three TF32 passes of the FLOPs),
and for the backward kernels :func:`backward_bound_seconds` (three TF32
passes, no reader in the benchmark yet). Prints one JSON line per kernel,
with the card's name and power limit. Exits 1 if the backward kernel takes
more than 0.25 ms a block at B=128, the wide backward kernel more than 1.0
ms or not less than its recompute, or the wide kernel is not faster than
its cuDNN chain. A checkout without the wide backward kernel (``--root``)
gets a line that says so. To compare two checkouts, run them in turns on
one card: A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
ITERS = 50
BACKWARD_MS_LIMIT = 0.25  # the backward kernel's target a block at B=128
WIDE_BACKWARD_MS_LIMIT = 1.0  # the wide backward kernel's, a block at B=128
TWIN_TOL = 1e-5  # fp32 cudnn_chain vs the plain twin, as the kernel is held (atol = rtol)
FLORIDA_SHAPES = [(150, 16, 16, 16), (8, 16, 32, 112), (128, 16, 16, 16)]
BF16_SHAPES = FLORIDA_SHAPES + [(132, 16, 16, 16)]
WIDE = (64, 32, 0.2)  # ESRGAN's block: filters, growth, slope
TRAIN_BATCH = 128


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls. The
    card first spins (``torch.cuda._sleep``) so that the host queues all the
    calls ahead of it, and a kernel shorter than its launch's host work (the
    bf16 DRB kernel: ~0.016 ms against ~0.025 ms of Python per call) is timed
    on the device, not at the host's launch rate. If the card had already
    finished spinning when the last call was queued, the spin is made four
    times longer and the calls timed again."""
    for _ in range(warmup):
        fn()
    spin = 2_000_000  # clock cycles, ~1 ms
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        queued_ahead = not start.query()  # still spinning: every call waits in the queue
        end.record()
        torch.cuda.synchronize()
        if queued_ahead or spin >= 2_000_000_000:
            return start.elapsed_time(end) / iters
        spin *= 4


def drb_params(f: int, rng: torch.Generator, device, growth: int | None = None):
    """Random DRB weights and biases with the generator's init bound,
    U(+-1/sqrt(fan_in)): stage s reads f + growth (s - 1) channels and
    writes growth (stage 5: f); growth f unless given."""
    growth = f if growth is None else growth
    ws, bs = [], []
    for s in range(5):
        cin, cout = f + growth * s, growth if s < 4 else f
        bound = 1.0 / (9 * cin) ** 0.5
        ws.append(((torch.rand(cout, cin, 3, 3, generator=rng) * 2 - 1) * bound).to(device))
        bs.append(((torch.rand(cout, generator=rng) * 2 - 1) * bound).to(device))
    return ws, bs


def backward_bound_seconds(batch: int, filters: int, h: int, w: int,
                           growth: int | None = None) -> float:
    """The least time a DRB backward kernel and its reduction can take:
    three TF32 passes of the recompute of stages 1-4 and of every stage's
    input and weight gradients (each a forward's FLOPs) at the TF32 peak,
    or x, the output gradient, dx and the weight partials (out and in
    again) at the memory rate, whichever is longer. ``growth`` None is
    DoWnGAN's block (``drb_backward_kernel``, a partial a sample); 32 at 64
    filters is ESRGAN's (``drb_backward_kernel_wide``, a partial a CTA of
    min(B, 64) two-CTA clusters): 0.2416 ms at B=128."""
    from portbench import flops

    widths = [(filters + (filters if growth is None else growth) * s,
               filters if growth is None or s == 4 else growth) for s in range(5)]
    convs = [2 * 9 * cin * cout * h * w for cin, cout in widths]
    ops = 3 * batch * (sum(convs[:4]) + 2 * sum(convs))
    slots = batch if growth is None else 2 * min(batch, 64)
    partials = slots * sum(9 * cin * cout + cout for cin, cout in widths) * 4
    nbytes = 3 * batch * filters * h * w * 4 + 2 * partials
    return max(ops / flops.PEAK_FLOPS["float32"], nbytes / flops.PEAK_BYTES)


def timed(shape, ms, yardstick_ms, bound_s, **extra) -> dict:
    bound_ms = bound_s * 1e3
    return {"shape": list(shape), "ms": ms, "yardstick_ms": yardstick_ms, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / ms, "vs_yardstick": yardstick_ms / ms, **extra}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose downgan_tpu_torch is timed (default: this one)")
    args = parser.parse_args()
    root = args.root.resolve()
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device; this tool runs on the card only", file=sys.stderr)
        return 1
    # The bounds from this checkout's benchmark, imported before the timed
    # checkout goes first on the path.
    sys.path.insert(0, str(HERE))
    from portbench import flops
    from portbench.reference import esrgan

    sys.path.insert(0, str(root))
    from downgan_tpu_torch.ops.cuda import drb

    if not Path(drb.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"{drb.__file__} is not under {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    common = {"root": str(root), "card": card, "iters": ITERS}
    rng = torch.Generator().manual_seed(1234)
    drb.load_library()
    failures = []

    with torch.inference_mode():
        for name, dtype, shapes in (("drb_kernel", torch.float32, FLORIDA_SHAPES),
                                    ("drb_kernel_bf16", torch.bfloat16, BF16_SHAPES)):
            label = "float32" if dtype == torch.float32 else "bfloat16"
            rows = []
            for shape in shapes:
                b, f, h, w = shape
                ws, bs = drb_params(f, rng, "cuda")
                x = torch.randn(*shape, generator=rng).cuda().to(dtype)
                packed = drb.pack_drb_weights(ws, bs, dtype)
                extra = {}
                if dtype == torch.float32:  # the yardstick computes the same block
                    chain = drb.cudnn_chain(x, ws, bs)
                    twin = drb.drb_forward_reference(x, ws, bs)
                    extra["yardstick_max_abs_err_vs_twin"] = (chain - twin).abs().max().item()
                    if not torch.allclose(chain, twin, atol=TWIN_TOL, rtol=TWIN_TOL):
                        failures.append(f"cudnn_chain is {extra} off the twin at {shape}")
                rows.append(timed(
                    shape, cuda_ms(lambda: drb.drb_forward(x, ws, bs, packed)),
                    cuda_ms(lambda: drb.cudnn_chain(x, ws, bs)),
                    flops.drb_bound_seconds(b, f, h, w, label), **extra))
            print(json.dumps({"kernel": name, "dtype": label, "yardstick": "cudnn_chain",
                              "bound": "portbench.flops.drb_bound_seconds", "shapes": rows,
                              **common}), flush=True)

        f, growth, slope = WIDE
        ws, bs = drb_params(f, rng, "cuda", growth)
        x = torch.randn(TRAIN_BATCH, f, 16, 16, generator=rng).cuda()
        packed = drb.pack_drb_weights(ws, bs)
        row = timed(x.shape, cuda_ms(lambda: drb.drb_forward(x, ws, bs, packed, slope)),
                    cuda_ms(lambda: drb.cudnn_chain(x, ws, bs, slope)),
                    esrgan.drb_bound_seconds(TRAIN_BATCH, f, growth, 16, 16))
        print(json.dumps({"kernel": "drb_kernel_wide", "dtype": "float32",
                          "block": {"filters": f, "growth": growth, "slope": slope},
                          "yardstick": "cudnn_chain",
                          "bound": "portbench.reference.esrgan.drb_bound_seconds",
                          "shapes": [row], **common}), flush=True)
        if not row["ms"] < row["yardstick_ms"]:
            failures.append(f"the wide kernel ({row['ms']} ms) is not faster than its cuDNN "
                            f"chain ({row['yardstick_ms']} ms)")

    shape = (TRAIN_BATCH, 16, 16, 16)
    ws, bs = drb_params(16, rng, "cuda")
    x = torch.randn(*shape, generator=rng).cuda()
    grad_out = torch.randn(*shape, generator=rng).cuda()
    row = timed(shape, cuda_ms(lambda: drb.drb_backward_kernel(x, ws, bs, grad_out)),
                cuda_ms(lambda: drb.drb_backward(x, ws, bs, grad_out)),
                backward_bound_seconds(*shape), limit_ms=BACKWARD_MS_LIMIT)
    print(json.dumps({"kernel": "drb_backward_kernel+drb_grad_reduce", "dtype": "float32",
                      "yardstick": "drb_backward (cuDNN recompute)",
                      "bound": "tools/time_kernels.py::backward_bound_seconds",
                      "shapes": [row], **common}), flush=True)
    if not row["ms"] <= BACKWARD_MS_LIMIT:
        failures.append(f"the DRB backward kernel takes {row['ms']} ms a block at B=128, "
                        f"over {BACKWARD_MS_LIMIT}")

    f, growth, slope = WIDE
    shape = (TRAIN_BATCH, f, 16, 16)
    ws, bs = drb_params(f, rng, "cuda", growth)
    x = torch.randn(*shape, generator=rng).cuda()
    grad_out = torch.randn(*shape, generator=rng).cuda()
    head = {"kernel": "drb_backward_kernel_wide+drb_grad_reduce_wide", "dtype": "float32",
            "block": {"filters": f, "growth": growth, "slope": slope},
            "yardstick": "drb_backward (cuDNN recompute)",
            "bound": "tools/time_kernels.py::backward_bound_seconds", **common}
    recompute_ms = cuda_ms(lambda: drb.drb_backward(x, ws, bs, grad_out, slope=slope))
    bound = backward_bound_seconds(*shape, growth=growth)
    if not hasattr(drb, "drb_backward_kernel_wide"):
        print(json.dumps({**head, "shapes": [], "absent": "this checkout has no wide backward "
                          "kernel", "yardstick_ms": recompute_ms, "bound_ms": bound * 1e3}),
              flush=True)
    else:
        packed = drb.pack_drb_weights(ws, bs)
        row = timed(shape, cuda_ms(lambda: drb.drb_backward_kernel_wide(x, ws, bs, grad_out,
                                                                        packed)),
                    recompute_ms, bound, limit_ms=WIDE_BACKWARD_MS_LIMIT)
        print(json.dumps({**head, "shapes": [row]}), flush=True)
        if not row["ms"] <= WIDE_BACKWARD_MS_LIMIT or not row["ms"] < recompute_ms:
            failures.append(f"the wide DRB backward kernel takes {row['ms']} ms a block at "
                            f"B=128, over {WIDE_BACKWARD_MS_LIMIT} or not under its recompute "
                            f"({recompute_ms} ms)")

    for message in failures:
        print(f"time_kernels: {message}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
