#!/usr/bin/env python3
"""Print the bf16 DRB gradient errors that
``tests/test_torch_drb.py::test_cuda_bf16_drb_function_gradients_match_float64``
holds to its limits, tensor by tensor, on one CUDA card.

    python3 tools/bf16_grad_errors.py

At the test's own inputs (``bf16_grad_case``: numpy-made, so the CPU side
of ``test_bf16_grad_limits_are_the_reference_error`` sees the same values),
``DRBFunction`` in bf16 (the bf16 kernel forward, the bf16 cuDNN recompute
backward) against the float64 gradient of the same block: each gradient's
largest error relative to its largest entry, then the worst tensor of each
kind beside the test's limits. One JSON line, with the card's name.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_drb as t  # noqa: E402
from downgan_tpu_torch.ops.cuda.drb import DRBFunction, pack_drb_weights  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_grad_errors: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x, weight, ws, bs = t.bf16_grad_case()
    ws = [torch.from_numpy(a).to(dev).requires_grad_() for a in ws]
    bs = [torch.from_numpy(a).to(dev).requires_grad_() for a in bs]
    x = torch.from_numpy(x).to(dev, torch.bfloat16).requires_grad_()
    weight = torch.from_numpy(weight).to(dev, torch.bfloat16)
    out = DRBFunction.apply(x, pack_drb_weights(ws, bs, torch.bfloat16), *ws, *bs)
    got = torch.autograd.grad((out.float() * weight.float()).sum(), [x, *ws, *bs])
    want = t.float64_grads(x, weight, ws, bs)
    names = ["x"] + [f"w{s}" for s in range(1, 6)] + [f"b{s}" for s in range(1, 6)]
    per_tensor = {n: ((g.double() - w).abs().max() / w.abs().max()).item()
                  for n, g, w in zip(names, got, want)}
    print(json.dumps({"card": torch.cuda.get_device_name(0), "per_tensor": per_tensor,
                      "by_kind": t.grad_errors_by_kind(got, want),
                      "limits": t.BF16_GRAD_LIMITS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
