"""Command line of the port (counterpart of ``downgan_tpu/cli/__main__.py``;
the port has ``serve`` and ``train``)::

    python -m downgan_tpu_torch.cli serve --config examples/florida.json \
        --weights generator.pt
    python -m downgan_tpu_torch.cli train --config examples/florida.json \
        --synthetic --samples 1440 --epochs 2

``--weights`` is a generator state dict written by the JAX package's
``python -m downgan_tpu.cli export-torch``. Restoring Orbax checkpoints
comes with the checkpoint slice. ``train`` runs on the synthetic set only:
the NetCDF staging tiers come with the data slice.
"""
from __future__ import annotations

import argparse

import torch


def _load_config(path):
    from downgan_tpu_torch.config.config import Config

    if not path:
        return Config()
    with open(path) as f:
        return Config.from_json(f.read())


def _fp32_without_tf32() -> None:
    # The port's models are fp32 (compute_dtype "float32"): keep cuDNN's
    # convs and the matmuls out of TF32, which PyTorch otherwise allows on
    # this card for convolutions.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _serve(args: argparse.Namespace) -> None:
    from downgan_tpu_torch.serving import BatchingSRModel, SRModel, serve_model
    from downgan_tpu_torch.utils.port_weights import load_generator_weights

    config = _load_config(args.config)
    _fp32_without_tf32()
    weights = load_generator_weights(args.weights)
    # 0 = uncapped; a literal 0-byte cap would refuse every domain request.
    out_cap = (args.max_domain_output_mb << 20) if args.max_domain_output_mb else (1 << 62)
    if args.coalesce:
        model = BatchingSRModel(config, weights, batch_size=args.serving_batch,
                                max_wait_ms=args.max_wait_ms,
                                max_domain_output_bytes=out_cap, device=args.device)
    else:
        model = SRModel(config, weights, batch_size=args.serving_batch,
                        max_domain_output_bytes=out_cap, device=args.device)
    server = serve_model(model, args.host, args.port)
    print(f"SR inference on http://{args.host}:{server.server_address[1]} "
          f"(batch {model.batch}, coalesce={args.coalesce}, device {model.device})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        # Drain the coalescer so queued requests get answers.
        if args.coalesce:
            model.close()


def _train(args: argparse.Namespace):
    """Train on the synthetic set, split 90/10 into train and test as the
    JAX package's ``train --synthetic``; returns the :class:`Trainer`."""
    import dataclasses

    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.training.state import resolve_device
    from downgan_tpu_torch.training.trainer import Trainer

    config = _load_config(args.config)
    hp = config.hp
    if args.batch_size is not None:
        hp = dataclasses.replace(hp, batch_size=args.batch_size)
    config = config.replace(hp=hp, seed=config.seed if args.seed is None else args.seed)
    device = resolve_device(args.device)
    _fp32_without_tf32()
    coarse, fine = synthetic_dataset(
        n_samples=args.samples, coarse_size=config.coarse_size, fine_size=config.fine_size,
        n_covariates=config.n_covariates, n_predictands=config.n_predictands, seed=config.seed)
    split = int(0.9 * args.samples)
    trainer = Trainer(config, DeviceDataset.from_numpy(coarse[:split], fine[:split], device),
                      DeviceDataset.from_numpy(coarse[split:], fine[split:], device),
                      device=device)
    trainer.train(args.epochs)
    return trainer


def _non_negative_int(text: str) -> int:
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return value


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m downgan_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser(
        "serve", help="Serve super-resolution inference over HTTP (POST .npy "
        "covariates to /v1/generate; GET /healthz, /metrics).")
    serve.add_argument("--config", default=None,
                       help="Config JSON (default: the built-in florida Config).")
    serve.add_argument("--weights", required=True,
                       help="Generator state dict (.pt) from `downgan_tpu.cli export-torch`.")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("-p", "--port", type=int, default=8080)
    serve.add_argument("--serving-batch", type=int, default=0,
                       help="Batch of every dispatch (0 = config.chunk_size).")
    serve.add_argument("--coalesce", action=argparse.BooleanOptionalAction, default=True,
                       help="Batch concurrent requests into one dispatch "
                       "(BatchingSRModel) instead of serializing them.")
    serve.add_argument("--max-wait-ms", type=float, default=5.0,
                       help="How long the coalescer lingers for stragglers.")
    serve.add_argument("--max-domain-output-mb", type=_non_negative_int, default=1024,
                       help="413 cap on a domain request's estimated output; 0 = uncapped.")
    serve.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    serve.set_defaults(func=_serve)

    train = sub.add_parser(
        "train", help="Train the WGAN-GP (reference schedule) and print the "
        "per-epoch train and test metric means, one JSON line each.")
    train.add_argument("--config", default=None,
                       help="Config JSON (default: the built-in florida Config).")
    train.add_argument("--synthetic", action="store_true",
                       help="Train on the synthetic dataset (required: the NetCDF "
                       "staging tiers are not ported yet).")
    train.add_argument("--samples", type=int, default=512, help="Synthetic sample count.")
    train.add_argument("--epochs", type=int, default=None,
                       help="Epochs (default: the config's hp.epochs).")
    train.add_argument("--batch-size", type=int, default=None,
                       help="Override the config's hp.batch_size.")
    train.add_argument("--seed", type=int, default=None, help="Override the config's seed.")
    train.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    train.set_defaults(func=_train)
    return parser


def main(argv=None):
    """Run one subcommand; returns what it returns (``train``: the
    Trainer)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "train" and not args.synthetic:
        parser.error("train needs --synthetic: the NetCDF staging tiers are not ported yet")
    return args.func(args)


if __name__ == "__main__":
    main()
