#!/usr/bin/env python3
"""Time the port's florida train step on one CUDA card, for this checkout or
for another checkout of the port (for example a parent commit unpacked with
``git archive``).

    python3 tools/time_train_step.py [--root DIR] [--label NAME] [--rounds N]

Builds the checkout's ``Trainer`` on florida (batch 128, seeded weights, a
synthetic set of 5 batches, fp32 with TF32 off), runs one warm-up round and
then ``--rounds`` rounds of 5 steps (one generator update and four
critic-only steps, the reference schedule), each step between CUDA events.
Prints one JSON line: the card as ``nvidia-smi`` names it, its power limit,
and the per-step times. To compare two checkouts, run them in turns on one
card: A, B, B, A.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=HERE,
                        help="checkout whose downgan_tpu_torch is timed")
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=4)
    args = parser.parse_args()
    root = args.root.resolve()
    import torch

    # This checkout's chip_smoke.py (the other checkout may have its own).
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, str(root))
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        print("time_train_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = Config.from_json((root / "examples" / "florida.json").read_text())
    coarse, fine = synthetic_dataset(n_samples=5 * chip_smoke.B_TRAIN, seed=config.seed)
    trainer = Trainer(config, DeviceDataset.from_numpy(coarse, fine, "cuda"), device="cuda")
    chip_smoke.time_round(trainer)  # warm-up: kernel build, cuDNN handles, packing
    update_ms, critic_ms = [], []
    for _ in range(args.rounds):
        update, critic = chip_smoke.time_round(trainer)
        update_ms += update
        critic_ms += critic
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "root": str(root), "batch": chip_smoke.B_TRAIN,
                      "card": smi, "update_step_ms": update_ms, "critic_only_step_ms": critic_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
