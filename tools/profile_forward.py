#!/usr/bin/env python3
"""Profile the port's florida generator forward at the serving batch on one
CUDA card, with ``chip_smoke.py``'s profile phase, for this checkout or for
another checkout of the port (for example a parent commit unpacked with
``git archive``).

    python3 tools/profile_forward.py [--root DIR] [--label NAME]

Prints one JSON line: the forward's time from CUDA events over 10 forwards
(seeded weights and inputs, fp32 with TF32 off), then the profile line
(device time by kernel and kernel class over 3 forwards). To compare two
checkouts, run them in turns on one card: A, B, B, A.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose downgan_tpu_torch is profiled")
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    root = args.root.resolve()
    import torch

    # This checkout's chip_smoke.py (the other checkout may have its own).
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, str(root))
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.training.state import make_generator

    if not torch.cuda.is_available():
        print("profile_forward: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = Config.from_json((root / "examples" / "florida.json").read_text())
    gen = make_generator(config, "cuda", rng=torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(1234)
    x = torch.randn(chip_smoke.B_MAIN, config.n_covariates, config.coarse_size,
                    config.coarse_size, generator=rng).cuda()
    with torch.inference_mode():
        forward_ms = chip_smoke.cuda_ms(lambda: gen(x), iters=10)
    print(json.dumps({"label": args.label, "root": str(root), "batch": chip_smoke.B_MAIN,
                      "forward_ms": forward_ms, "card": torch.cuda.get_device_name(0)}),
          flush=True)
    chip_smoke.phase_profile(config, gen, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
