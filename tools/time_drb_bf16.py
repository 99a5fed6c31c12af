#!/usr/bin/env python3
"""Time the bf16 DRB kernel of this checkout, or of another checkout of the
port (for example a parent commit unpacked with ``git archive``), on one
CUDA card, at the shapes ``chip_smoke.py`` times it.

    python3 tools/time_drb_bf16.py [--root DIR] [--label NAME] [--repeats N]

Builds the checkout's ``drb.cu`` (into that checkout's ``build/``), checks
the kernel against its float64 evaluation with ``chip_smoke.py``'s bf16
criterion, then prints one JSON line per shape: the kernel's mean time
from CUDA events over 50 launches (``chip_smoke.cuda_ms``), once per
repeat, beside its bound (FLOP at the card's bf16 tensor-core peak). To
compare two checkouts, run them in turns on one card: A, B, B, A.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = [(150, 16, 16, 16), (132, 16, 16, 16), (128, 16, 16, 16), (8, 16, 32, 112)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose downgan_tpu_torch is timed")
    parser.add_argument("--label", default="")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    root = args.root.resolve()
    import torch

    if not torch.cuda.is_available():
        print("time_drb_bf16: no CUDA device", file=sys.stderr)
        return 1
    # This checkout's chip_smoke.py for the timer and the criterion.
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, str(root))
    from downgan_tpu_torch.ops.cuda import drb

    assert Path(drb.__file__).resolve().is_relative_to(root), drb.__file__
    name = torch.cuda.get_device_name(0)
    peaks = chip_smoke.card_peaks(name)
    rng = torch.Generator().manual_seed(1234)
    with torch.inference_mode():
        for shape in SHAPES:
            b, f, h, w = shape
            ws, bs = chip_smoke.drb_params(f, rng, "cuda")
            x = torch.randn(*shape, generator=rng).cuda().to(torch.bfloat16)
            packed = drb.pack_drb_weights(ws, bs, torch.bfloat16)
            got = drb.drb_forward(x, ws, bs, packed).double()
            twin = drb.drb_forward_reference(x, ws, bs).double()
            want = drb.drb_forward_reference(x, ws, bs, sum_dtype=torch.float64).double()
            ulp = chip_smoke.bf16_ulp(want.abs().max().item())
            kernel_err = (got - want).abs().max().item()
            twin_err = (twin - want).abs().max().item()
            vs_twin = (got - twin).abs().max().item()
            ok = (kernel_err <= max(chip_smoke.BF16_VS_FP64_TWIN_FACTOR * twin_err, ulp)
                  and vs_twin <= chip_smoke.BF16_KERNEL_VS_TWIN_ULPS * ulp)
            times = [chip_smoke.cuda_ms(lambda: drb.drb_forward(x, ws, bs, packed), iters=50)
                     for _ in range(args.repeats)]
            bound_ms = chip_smoke.drb_flops(b, f, h, w) / (peaks["bf16"] * 1e12) * 1e3
            print(json.dumps({"label": args.label, "root": str(root), "shape": list(shape),
                              "ms": times, "bound_ms": bound_ms,
                              "share_of_bound": [bound_ms / t for t in times],
                              "kernel_vs_twin_ulps": vs_twin / ulp, "ok": ok, "card": name}),
                  flush=True)
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
