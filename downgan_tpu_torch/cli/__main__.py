"""Command line of the port (counterpart of ``downgan_tpu/cli/__main__.py``;
this slice ports ``serve``)::

    python -m downgan_tpu_torch.cli serve --config examples/florida.json \
        --weights generator.pt

``--weights`` is a generator state dict written by the JAX package's
``python -m downgan_tpu.cli export-torch``. Restoring Orbax checkpoints
comes with the checkpoint slice.
"""
from __future__ import annotations

import argparse

import torch


def _serve(args: argparse.Namespace) -> None:
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.serving import BatchingSRModel, SRModel, serve_model
    from downgan_tpu_torch.utils.port_weights import load_generator_weights

    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    else:
        config = Config()
    # The served model is fp32 (compute_dtype "float32"): keep cuDNN's convs
    # out of TF32, which PyTorch otherwise allows on this card.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
