"""Command line of the port (counterpart of ``downgan_tpu/cli/__main__.py``,
every command and option of it under the same names, plus ``--device``
and ``serve --weights``)::

    python -m downgan_tpu_torch.cli train --config examples/florida.json \
        --synthetic --samples 1440 --epochs 2 --track-best MSSSIM
    python -m downgan_tpu_torch.cli prepare-data --config my_region.json
    python -m downgan_tpu_torch.cli train --config my_region.json   # or --host-feed, --stream
    python -m downgan_tpu_torch.cli train --config examples/production_tuned.json \
        --synthetic --samples 1440 --epochs 2    # bf16, fused rounds
    python -m downgan_tpu_torch.cli train ... --resume      # after a SIGTERM
    python -m downgan_tpu_torch.cli train ... --noise-channels 4       # stochastic
    python -m downgan_tpu_torch.cli train ... --generator-arch srresnet
    python -m downgan_tpu_torch.cli train ... --freq-sep --critic-conditional \
        --augment-flips --eof-lambda 1 --grad-accum 2 \
        --lr-schedule cosine --lr-warmup-steps 2 --lr-decay-steps 10
    python -m torch.distributed.run --nproc-per-node 8 -m downgan_tpu_torch.cli \
        train --multihost --checkpoint-dir ckpt ...   # data-parallel, a rank per card
    python -m downgan_tpu_torch.cli serve --checkpoint <run artifacts>/best
    python -m downgan_tpu_torch.cli export --run <run id> --ema --out bundle/
    python -m downgan_tpu_torch.cli serve --weights generator.pt
    python -m downgan_tpu_torch.cli generate --run <run id> --streamed --tile-rows 16
    python -m downgan_tpu_torch.cli generate --checkpoint <bundle> --synthetic --ensemble 8
    python -m downgan_tpu_torch.cli evaluate --run <run id> --ema --ensemble 8
    python -m downgan_tpu_torch.cli profile --mode train --steps 3 --out profiles
    python -m downgan_tpu_torch.cli tune --batches 64,128 --dtypes float32,bfloat16 --out tuned.json
    python -m downgan_tpu_torch.cli import-torch --weights G.pt --critic-weights C.pt --out bundle/
    python -m downgan_tpu_torch.cli export-torch --run <run id> --ema --out generator.pt
    python -m downgan_tpu_torch.cli export-mlflow --run <run id> --out mlruns
    python -m downgan_tpu_torch.cli serve-tracking --root experiments -p 5555
    python -m downgan_tpu_torch.cli show-config --config examples/florida.json

``train`` tracks each run under ``--tracking-root`` (the JAX package's
layout, ``tracking/store.py``) and checkpoints the full train state every
epoch into ``<run artifacts>/checkpoints``. ``serve``, ``export``,
``generate`` and ``evaluate`` take a bundle or trainer checkpoint directory
(``--checkpoint``), a tracked run (``--run``) or, for ``serve``, a
generator state dict (``--weights``, a bundle's ``generator.pt`` or the JAX
package's ``export-torch`` file; ``generate``/``evaluate`` take it as
``--checkpoint F --weights-only``). ``generate`` writes NetCDF through
``h5py``; with more than one card visible, its tiles and ``serve``'s
domain requests split over all of them.
Without ``--synthetic``, ``train`` stages the config's data: the
preprocessed NetCDFs (``already_preprocessed``, written by
``prepare-data``) or the raw ones, onto the device; with ``--host-feed``
into host RAM, fed batch by batch; with ``--stream`` left on disk in the
preprocessed files and read batch by batch. With ``--multihost`` every
rank of the job runs the same command (under torchrun, or with
``--coordinator``/``--num-processes``/``--process-id``) and trains
data-parallel on its own card: ``hp.batch_size`` is the global batch, rank
0 tracks the run and writes the checkpoints into the shared
``--checkpoint-dir``.
``profile``, ``tune`` and ``import-torch`` compute on ``--device`` (default
``cuda``; ``--device cpu`` without a card). ``show-config``,
``serve-tracking``, ``export-mlflow`` and ``export-torch`` touch no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch


def _load_config(path, region=None):
    """The config at ``path`` (default: the built-in florida Config), with
    ``region`` when given (the JAX CLI's ``_load_config``)."""
    from downgan_tpu_torch.config.config import Config

    if not path:
        config = Config()
    else:
        with open(path) as f:
            config = Config.from_json(f.read())
    return config if region is None else config.replace(region=region)


def _fp32_without_tf32() -> None:
    # A model computing in fp32 (compute_dtype "float32") computes in fp32:
    # keep cuDNN's convs and the matmuls out of TF32, which PyTorch
    # otherwise allows on this card for convolutions. (bf16 compute does
    # not read these flags.)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _source(args: argparse.Namespace, parser: argparse.ArgumentParser):
    """``--weights``/``--checkpoint``/``--run`` -> ``(config, path,
    weights_only, run)``: the file or checkpoint directory to restore from,
    whether it holds one set of generator weights (``--weights``, a
    bundle, or ``--checkpoint`` with ``--weights-only``), and the tracked
    run under ``--run``. A bundle brings its own config and ``--run`` the
    one the run logged; a trainer checkpoint directory inside a run's
    artifacts picks up the logged ``config.json`` beside it; an explicit
    ``--config`` wins over all of them. Contradictory flags are usage
    errors."""
    from downgan_tpu_torch.inference import GENERATOR_FILE, is_bundle, resolve_run_checkpoint

    weights = getattr(args, "weights", None)
    sources = [s for s in (weights, args.checkpoint, args.run) if s is not None]
    if len(sources) != 1:
        flags = "--weights, --checkpoint or --run" if hasattr(args, "weights") else \
            "--checkpoint or --run"
        parser.error(f"pass exactly one of {flags}")
    config_file = run = None
    if weights is not None:
        path, weights_only = weights, True
    elif is_bundle(args.checkpoint):
        path, weights_only = os.path.join(args.checkpoint, GENERATOR_FILE), True
        config_file = os.path.join(args.checkpoint, "config.json")
    elif args.run is not None:
        run, path, _ = resolve_run_checkpoint(args.tracking_root, args.run)
        weights_only, config_file = False, os.path.join(run.artifact_dir, "config.json")
    else:
        path, weights_only = args.checkpoint, getattr(args, "weights_only", False)
        config_file = os.path.join(os.path.dirname(os.path.abspath(path)), "config.json")
    if args.config:
        config = _load_config(args.config)
    else:
        config = _load_config(config_file if config_file and os.path.exists(config_file)
                              else None)
    if getattr(args, "region", None):
        config = config.replace(region=args.region)
    return config, path, weights_only, run


def _restore(path: str, weights_only: bool, args: argparse.Namespace,
             parser: argparse.ArgumentParser):
    """The generator weights at ``path`` (``--epoch``, ``--ema``), with the
    flag contradictions as usage errors."""
    from downgan_tpu_torch.inference import RestoreUsageError, restore_generator_params

    try:
        return restore_generator_params(path, step=args.epoch, weights_only=weights_only,
                                        use_ema=args.ema)
    except RestoreUsageError as e:
        parser.error(str(e))


def _resolve_source(args: argparse.Namespace, parser: argparse.ArgumentParser):
    """:func:`_source`'s config and the generator weights it restores."""
    config, path, weights_only, _ = _source(args, parser)
    return config, _restore(path, weights_only, args, parser)


def _devices(args: argparse.Namespace):
    """Every visible card when ``--device`` is a card and more than one is
    visible (the JAX package meshes every local device), else ``None``:
    ``--device`` alone."""
    if torch.device(args.device).type == "cuda" and torch.cuda.device_count() > 1:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return None


def _serve(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    from downgan_tpu_torch.serving import BatchingSRModel, SRModel, serve_model

    config, weights = _resolve_source(args, parser)
    _fp32_without_tf32()
    # 0 = uncapped; a literal 0-byte cap would refuse every domain request.
    out_cap = (args.max_domain_output_mb << 20) if args.max_domain_output_mb else (1 << 62)
    # Domain requests split their tiles over every visible card (--mesh).
    devices = _devices(args) if args.mesh else None
    if args.coalesce:
        model = BatchingSRModel(config, weights, batch_size=args.serving_batch,
                                max_wait_ms=args.max_wait_ms,
                                max_domain_output_bytes=out_cap, device=args.device,
                                devices=devices)
    else:
        model = SRModel(config, weights, batch_size=args.serving_batch,
                        max_domain_output_bytes=out_cap, device=args.device, devices=devices)
    server = serve_model(model, args.host, args.port)
    print(f"SR inference on http://{args.host}:{server.server_address[1]} "
          f"(batch {model.batch}, coalesce={args.coalesce}, device {model.device}"
          f"{f', domain tiles over {len(devices)} cards' if devices else ''})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        # Drain the coalescer so queued requests get answers.
        if args.coalesce:
            model.close()


def _export(args: argparse.Namespace, parser: argparse.ArgumentParser) -> str:
    """Write a servable bundle (generator weights + config; no critic, no
    optimizer state) from a trainer checkpoint; returns its directory."""
    from downgan_tpu_torch.inference import is_bundle, write_generator_bundle

    if is_bundle(args.checkpoint):
        parser.error(f"{args.checkpoint} is already an exported bundle")
    config, weights = _resolve_source(args, parser)
    out = write_generator_bundle(args.out, config, weights)
    print(f"exported {'EMA ' if args.ema else ''}generator bundle to {out}", flush=True)
    return out


def _require_preprocessed(config, parser: argparse.ArgumentParser, other: str = "") -> None:
    """A usage error that names ``prepare-data`` when any of the config's
    four preprocessed files is missing (``other``: another way out)."""
    from downgan_tpu_torch.data.staging import preprocessed_path

    missing = [p for p in (preprocessed_path(config, kind, split) for kind in ("coarse", "fine")
                           for split in ("train", "test")) if not os.path.exists(p)]
    if missing:
        parser.error(f"no preprocessed data: {', '.join(missing)} missing; run `prepare-data` "
                     f"with this config first, {other}or pass --synthetic")


def _datasets(args: argparse.Namespace, parser: argparse.ArgumentParser, config, device):
    """The train and test sets of ``train``: the synthetic set split 90/10
    (as the JAX package's ``train --synthetic``) or the config's data, on
    the device, in host RAM (``--host-feed``) or on disk (``--stream``).
    Missing preprocessed files are a usage error that names
    ``prepare-data``."""
    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.data.feed import HostDataset
    from downgan_tpu_torch.data.staging import generate_train_test_coarse_fine, load_preprocessed
    from downgan_tpu_torch.data.stream import StreamDataset

    def residency(coarse, fine):
        if args.host_feed:
            return HostDataset(coarse, fine)
        return DeviceDataset.from_numpy(coarse, fine, device)

    if args.synthetic:
        coarse, fine = synthetic_dataset(
            n_samples=args.samples, coarse_size=config.coarse_size, fine_size=config.fine_size,
            n_covariates=config.n_covariates, n_predictands=config.n_predictands,
            seed=config.seed)
        split = int(0.9 * args.samples)
        return residency(coarse[:split], fine[:split]), residency(coarse[split:], fine[split:])
    if args.stream or config.already_preprocessed:
        _require_preprocessed(config, parser, "set already_preprocessed false to stage its "
                              "raw files, ")
    if args.stream:
        return (StreamDataset.from_preprocessed(config, "train"),
                StreamDataset.from_preprocessed(config, "test"))
    if config.already_preprocessed:
        ct, ft, cv, fv = load_preprocessed(config)
    else:
        ct, ft, cv, fv = generate_train_test_coarse_fine(config)
    return residency(ct, ft), residency(cv, fv)


def _join_ranks(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    """Join the job under ``--multihost``; refuse the ways a multi-card run
    would quietly train on one card or as N lone runs."""
    from downgan_tpu_torch.parallel.mesh import in_group
    from downgan_tpu_torch.parallel.multihost import initialize

    if args.multihost:
        if args.checkpoint_dir is None:
            parser.error("--multihost requires --checkpoint-dir (a directory every rank reads: "
                         "rank 0 writes the checkpoints and every rank restores from them)")
        initialize(args.coordinator, args.num_processes, args.process_id)
        if not in_group() and args.num_processes != 1:
            parser.error("--multihost was requested but no process group formed (no torchrun "
                         "environment and no --coordinator). Launch with python -m "
                         "torch.distributed.run, pass --coordinator/--num-processes/"
                         "--process-id, or --num-processes 1 for a single-process run.")
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        parser.error("this process is one rank of a job of WORLD_SIZE="
                     f"{os.environ['WORLD_SIZE']}: pass --multihost, or each rank trains alone")
    if (args.mesh and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() > 1 and not in_group()):
        parser.error(f"{torch.cuda.device_count()} cards are visible and one process trains on "
                     "one card: train data-parallel on all of them with python -m "
                     "torch.distributed.run --nproc-per-node "
                     f"{torch.cuda.device_count()} -m downgan_tpu_torch.cli train --multihost "
                     "--checkpoint-dir DIR ..., or pass --no-mesh to train on one card")


def _train(args: argparse.Namespace, parser: argparse.ArgumentParser):
    """Train as one tracked run; returns the :class:`Trainer`."""
    from downgan_tpu_torch.inference import CRITIC_FILE, is_bundle, load_bundle
    from downgan_tpu_torch.parallel.mesh import in_group, rank
    from downgan_tpu_torch.parallel.multihost import local_device
    from downgan_tpu_torch.tracking import (TrackingStore, define_experiment, log_hyperparams,
                                            write_tags)
    from downgan_tpu_torch.training.state import resolve_device
    from downgan_tpu_torch.training.trainer import Trainer
    from downgan_tpu_torch.utils.checkpoint import CheckpointManager

    _join_ranks(args, parser)
    primary = rank() == 0
    config = _load_config(args.config, args.region)
    overrides = {k: getattr(args, k) for k in (
        "batch_size", "epochs", "lr", "compute_dtype", "schedule", "lr_schedule", "lr_warmup_steps",
        "lr_decay_steps", "lr_final_factor", "augment_flips", "grad_accum", "eof_lambda",
        "freq_sep") if getattr(args, k) is not None}
    try:
        config = config.replace(hp=dataclasses.replace(config.hp, **overrides),
                                seed=config.seed if args.seed is None else args.seed)
    except ValueError as e:  # HyperParams' own validation of the overrides
        parser.error(str(e))
    if args.critic_conditional is not None:
        config = config.replace(critic_conditional=args.critic_conditional)
    if args.generator_arch is not None:
        config = config.replace(generator_arch=args.generator_arch)
    if args.noise_channels is not None:
        if args.noise_channels < 0:
            parser.error("--noise-channels must be >= 0")
        config = config.replace(noise_channels=args.noise_channels)
    if args.host_feed and args.stream:
        parser.error("--host-feed and --stream are different residency tiers (host RAM vs "
                     "disk); pick one")
    if args.stream and args.synthetic:
        parser.error("--stream reads the preprocessed NetCDF layout; --synthetic has no files "
                     "to stream (run `prepare-data` on real data, or use --host-feed to "
                     "exercise the streaming loop in RAM)")
    if args.host_feed or args.stream:
        if config.hp.fused_epoch or config.hp.schedule == "fused":
            print("host feed: using the per-step loop (hp.fused_epoch=False, "
                  "schedule='reference')", file=sys.stderr, flush=True)
        config = config.replace(hp=dataclasses.replace(config.hp, fused_epoch=False,
                                                       schedule="reference"))
    if args.warm_start:
        # The bundle's weights fix the model's shape; they load after the
        # resume decision, so a resumed run never reads them.
        if not is_bundle(args.warm_start):
            parser.error(f"{args.warm_start} is not a bundle directory (expected "
                         "generator.pt + config.json, the `export` layout)")
        bundle_config = _load_config(os.path.join(args.warm_start, "config.json"))
        for flag, field, what in (("--generator-arch", "generator_arch", "the architecture"),
                                  ("--noise-channels", "noise_channels",
                                   "the generator input width")):
            ours, theirs = getattr(args, field), getattr(bundle_config, field)
            if ours is not None and ours != theirs:
                parser.error(f"{flag} {ours} conflicts with the bundle's {field}={theirs!r} "
                             f"(the warm-start weights fix {what})")
        config = config.replace(**{k: getattr(bundle_config, k) for k in (
            "filters", "num_res_blocks", "n_covariates", "n_predictands", "coarse_size",
            "fine_size", "generator_arch", "noise_channels")})
        has_critic = os.path.exists(os.path.join(args.warm_start, CRITIC_FILE))
        if has_critic and config.critic_conditional != bundle_config.critic_conditional:
            parser.error("the bundle's critic was trained with critic_conditional="
                         f"{bundle_config.critic_conditional}; pass a matching "
                         "--critic-conditional (or drop the bundle's critic.pt to warm-start "
                         "the generator only)")
    device = resolve_device(local_device(args.device))
    _fp32_without_tf32()
    train_ds, test_ds = _datasets(args, parser, config, device)

    # Under --multihost rank 0 tracks the run; every rank checkpoints into
    # the shared --checkpoint-dir (rank 0 writes).
    run = None
    if primary:
        store = TrackingStore(args.tracking_root)
        # --interactive without --experiment: the reference's stdin picker.
        name = args.experiment
        if name is None and not args.interactive:
            name = "downgan-tpu"
        exp_id = define_experiment(store, name, interactive=args.interactive,
                                   tag=config.experiment_tag)
        run = store.create_run(exp_id, run_name=args.run_name).start()
        log_hyperparams(run, config)
        write_tags(run, interactive=args.interactive)
        with open(run.artifact_path("config.json"), "w") as f:
            f.write(config.to_json())
        if args.mlflow_dir is not None:
            # After params, tags and config.json, so the seeding export has them.
            from downgan_tpu_torch.tracking.mlflow_export import MlflowLiveRun

            run.attach_sink(MlflowLiveRun(run, args.mlflow_dir))
            print(f"mirroring live to MLflow FileStore {args.mlflow_dir} (view: mlflow ui "
                  f"--backend-store-uri {os.path.abspath(args.mlflow_dir)})", file=sys.stderr,
                  flush=True)
    tb_dir = None
    if args.tensorboard and run is not None:
        import importlib.util

        tb_dir = os.path.join(run.artifact_dir, "tensorboard")
        if importlib.util.find_spec("tensorboardX") is None:
            print("--tensorboard: tensorboardX is not installed here; nothing is logged to "
                  "TensorBoard", file=sys.stderr, flush=True)
    max_ckpt = config.max_checkpoints if args.max_checkpoints is None else args.max_checkpoints
    ckpt = CheckpointManager(
        args.checkpoint_dir or os.path.join(run.artifact_dir, "checkpoints"),
        max_to_keep=max_ckpt,
        keep_period=config.keep_checkpoint_every if args.keep_every is None else args.keep_every)
    try:
        trainer = Trainer(config, train_ds, test_ds, device=device, run=run,
                          checkpoint_manager=ckpt, save_every=args.save_every,
                          print_every=args.print_every, track_best=args.track_best,
                          best_mode=args.best_mode,
                          multihost=args.multihost and in_group(),
                          plot_every=args.plot_every, tensorboard_dir=tb_dir)
        resumed = trainer.maybe_resume() if args.resume else False
        if args.warm_start and not resumed:
            _, g_weights, c_weights = load_bundle(args.warm_start)
            trainer.warm_start(g_weights, c_weights)
        trainer.train()
        # KILLED is MLflow's status for a run stopped from outside; the full
        # state is checkpointed either way.
        if run is not None:
            run.end("KILLED" if trainer.preempted else "FINISHED")
    except BaseException:
        if run is not None:
            run.end("FAILED")
        raise
    finally:
        ckpt.close()
        if args.stream:
            train_ds.close()
            test_ds.close()
    if run is not None:
        if trainer.preempted:
            print(f"preempted after epoch {trainer.epoch - 1}: checkpoint saved; re-run with "
                  "--resume to continue the exact trajectory", file=sys.stderr, flush=True)
        print(f"run {run.run_id} finished; artifacts in {run.artifact_dir}", file=sys.stderr,
              flush=True)
    return trainer


def _generate(args: argparse.Namespace, parser: argparse.ArgumentParser) -> str:
    """Generate fields from a trained generator into a NetCDF (the
    reference's ``gen_fake_ds.py``); returns the file's path."""
    import numpy as np

    from downgan_tpu_torch.inference import (generate_ensemble, generate_fields,
                                             generate_to_netcdf, rebuild_coarse_covariates,
                                             write_generated_netcdf)
    from downgan_tpu_torch.parallel.spatial import tiled_sr_inference

    if args.ensemble and args.tile_rows:
        parser.error("--ensemble and --tile-rows are mutually exclusive (tiled domains "
                     "generate one member per call; loop members with different runs if needed)")
    try:
        import h5py  # noqa: F401
    except ImportError:
        parser.error("generate writes NetCDF through h5py, which is not installed here")
    config, path, weights_only, run = _source(args, parser)
    if args.ensemble and config.noise_channels <= 0:
        parser.error("--ensemble needs a stochastic generator (trained with "
                     "Config.noise_channels > 0); this model is deterministic")
    out = args.out or (os.path.join(run.artifact_dir, "generated_ds.nc") if run is not None
                       else "generated.nc")
    times = lats = lons = None
    if args.synthetic:
        from downgan_tpu_torch.data.dataset import synthetic_dataset

        coarse, _ = synthetic_dataset(
            n_samples=args.samples, coarse_size=config.coarse_size, fine_size=config.fine_size,
            n_covariates=config.n_covariates, n_predictands=config.n_predictands,
            seed=config.seed)
    elif args.raw_covariates:
        from downgan_tpu_torch.data.staging import load_fine_coords

        # The fine crop's coordinates, as the reference's generated dataset
        # carries them (gen_fake_ds.py:86-90, 162).
        coarse, times = rebuild_coarse_covariates(config, subset=args.subset)
        lats, lons = load_fine_coords(config)
    else:
        from downgan_tpu_torch.data.staging import load_preprocessed, load_preprocessed_coords

        _require_preprocessed(config, parser, "pass --raw-covariates, ")
        ct, _, cv, _ = load_preprocessed(config)
        coarse = ct if args.subset == "train" else cv
        lats, lons = load_preprocessed_coords(config)
    if args.ema and weights_only:
        parser.error("--ema needs the full-train-state checkpoint layout; weights-only "
                     "checkpoints hold one set of params")
    weights = _restore(path, weights_only, args, parser)
    if times is not None:
        times = np.asarray(times)
        if times.dtype.kind == "M":  # datetime64 -> epoch seconds
            times = times.astype("datetime64[s]").astype("float64")
    # True coordinates only where their length is the generated grid's (a
    # model whose upsampling differs from the data's scale factor).
    sf = 2 ** config.num_upsample
    if lats is not None and len(lats) != coarse.shape[1] * sf:
        lats = None
    if lons is not None and len(lons) != coarse.shape[2] * sf:
        lons = None
    _fp32_without_tf32()
    # Tiles split over every visible card, as the JAX command meshes them.
    devices = _devices(args) if args.tile_rows else None
    tiling = dict(tile_rows=args.tile_rows, overlap=args.overlap, tile_cols=args.tile_cols,
                  tiles_per_dispatch=args.tiles_per_dispatch)
    if args.streamed:
        generate_to_netcdf(out, config, weights, coarse, times=times, lats=lats, lons=lons,
                           n_members=args.ensemble, device=args.device, devices=devices, **tiling)
        what = (f"{coarse.shape[0]} generated fields x {args.ensemble} members"
                if args.ensemble else f"{coarse.shape[0]} generated fields")
        print(f"wrote {what} to {out} (streamed)", flush=True)
        return out
    if args.tile_rows:
        fields = tiled_sr_inference(config, weights, coarse, device=args.device, devices=devices,
                                    **tiling)
    elif args.ensemble:
        fields = generate_ensemble(config, weights, coarse, args.ensemble, device=args.device)
    else:
        fields = generate_fields(config, weights, coarse, device=args.device)
    write_generated_netcdf(out, fields, times=times, lats=lats, lons=lons)
    what = (f"{fields.shape[1]} generated fields x {fields.shape[0]} members"
            if fields.ndim == 5 else f"{fields.shape[0]} generated fields")
    print(f"wrote {what} to {out}", flush=True)
    return out


def _evaluate(args: argparse.Namespace, parser: argparse.ArgumentParser) -> dict:
    """The test-set metric pass from a checkpoint: the config's metrics
    over every sample of a split (the ragged tail its own batch), printed
    as one JSON line; returns that line's dict."""
    import numpy as np

    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.training.state import make_critic, make_train_state, resolve_device
    from downgan_tpu_torch.training.trainer import full_split_metric_pass
    from downgan_tpu_torch.training.wgan import build_eval_metrics

    config, path, weights_only, _ = _source(args, parser)
    if weights_only and "Wass" in config.hp.metrics_to_calculate:
        print("warning: --weights-only checkpoints carry no critic; dropping the Wass metric",
              file=sys.stderr, flush=True)
        config = config.replace(hp=dataclasses.replace(config.hp, metrics_to_calculate=tuple(
            m for m in config.hp.metrics_to_calculate if m != "Wass")))
    if args.ensemble and config.noise_channels <= 0:
        parser.error("--ensemble needs a stochastic generator (trained with "
                     "Config.noise_channels > 0); this model is deterministic")
    if args.synthetic:
        coarse, fine = synthetic_dataset(
            n_samples=args.samples, coarse_size=config.coarse_size, fine_size=config.fine_size,
            n_covariates=config.n_covariates, n_predictands=config.n_predictands,
            seed=config.seed)
    else:
        from downgan_tpu_torch.data.staging import load_preprocessed

        _require_preprocessed(config, parser)
        ct, ft, cv, fv = load_preprocessed(config)
        coarse, fine = (ct, ft) if args.split == "train" else (cv, fv)
    device = resolve_device(args.device)
    _fp32_without_tf32()
    ds = DeviceDataset.from_numpy(coarse, fine, device)
    if weights_only:
        if args.ema:
            parser.error("--ema needs the full-train-state checkpoint layout; weights-only "
                         "checkpoints hold one set of params")
        from downgan_tpu_torch.training.state import load_generator

        gen, critic, step = load_generator(config, _restore(path, True, args, parser),
                                           device), make_critic(config, device), 0
    else:
        from downgan_tpu_torch.utils.checkpoint import CheckpointManager

        try:
            saved = CheckpointManager(path).restore(args.epoch)
        except FileNotFoundError as e:
            parser.error(str(e))
        if args.ema and saved["g_ema"] is None:
            parser.error("--ema requires an EMA-trained run (hp.ema_decay > 0)")
        state = make_train_state(config, device)
        state.load_state_dict(saved)
        gen, critic, step = state.g_ema if args.ema else state.generator, state.critic, state.step
    gen.eval()
    critic.eval()
    eval_metrics = build_eval_metrics(config)
    means = full_split_metric_pass(ds, config.hp.batch_size,
                                   lambda c, f: eval_metrics(gen, critic, c, f))
    result = {"split": "synthetic" if args.synthetic else args.split, "n_samples": len(ds),
              "step": int(step), **{k: round(v, 6) for k, v in means.items()}}
    if args.ensemble:
        from downgan_tpu_torch.inference import ensemble_metrics

        ens = ensemble_metrics(config, gen.state_dict(), np.asarray(coarse, np.float32),
                               np.asarray(fine, np.float32), args.ensemble, device=device)
        result.update({k: round(v, 6) if isinstance(v, float) else v for k, v in ens.items()})
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line)
    print(line, flush=True)
    return result


def _prepare_data(args: argparse.Namespace, parser: argparse.ArgumentParser):
    """Write the 4 preprocessed train/test NetCDFs (parity with the
    reference's ``helpers/gen_train_test_netcdfs.py``); returns their paths."""
    from downgan_tpu_torch.data.staging import (generate_train_test_coarse_fine,
                                                load_fine_coords, write_preprocessed)

    config = _load_config(args.config, args.region)
    arrays = generate_train_test_coarse_fine(config)
    lats, lons = load_fine_coords(config)
    paths = write_preprocessed(config, *arrays, fine_lats=lats, fine_lons=lons)
    for p in paths:
        print(p, flush=True)
    return paths


def _prepare_covariates(args: argparse.Namespace, parser: argparse.ArgumentParser):
    """Write one standardized NetCDF per covariate for a region and split,
    and the statistics as JSON (parity with the legacy
    ``helpers/covariates.py`` CLI); returns the paths, statistics first."""
    import numpy as np

    from downgan_tpu_torch.config.config import COVARIATE_NAMES_ORDERED
    from downgan_tpu_torch.data.netcdf import write_netcdf
    from downgan_tpu_torch.data.pipeline import standardize_all
    from downgan_tpu_torch.data.staging import load_covariates, load_fine
    from downgan_tpu_torch.data.times import filter_times

    config = _load_config(args.config, args.region)
    _, times = load_fine(config)
    if times is None:
        times = np.asarray(config.range_datetimes)
    n_times = len(times)
    cov = load_covariates(config, n_times)

    train_mask = filter_times(times[:n_times], mask_years=config.mask_years)
    sel_mask = train_mask.copy() if args.which_set == "train" else ~train_mask
    sel_mask[0] = False  # legacy quirk: the first WRF field is dropped (covariates.py)
    # The statistics' masks follow the reference (covariates.py:60-64,
    # 115-147): the train split standardizes over itself (first field
    # already dropped); the validation split over ~sel_mask, taken after
    # the drop, i.e. the train times plus the dropped first field.
    stats_mask = sel_mask if args.which_set == "train" else ~sel_mask
    _, stats = standardize_all({k: v[stats_mask] for k, v in cov.items()})
    standardized, _ = standardize_all({k: v[sel_mask] for k, v in cov.items()}, stats=stats)

    os.makedirs(config.proc_data_dir, exist_ok=True)
    stats_path = os.path.join(config.proc_data_dir, f"cov_stats_{config.region}.json")
    with open(stats_path, "w") as f:
        json.dump({k: list(v) for k, v in stats.items()}, f, indent=2)
    paths = [stats_path]
    for name in COVARIATE_NAMES_ORDERED:
        arr = np.asarray(standardized[name], dtype=np.float32)
        path = os.path.join(config.proc_data_dir,
                            f"cov_{name}_{args.which_set}_{config.region}.nc")
        write_netcdf(path, variables={name: arr}, dims={name: ("time", "lat", "lon")},
                     coords={"time": np.arange(arr.shape[0], dtype=np.float64)})
        paths.append(path)
    for p in paths:
        print(p, flush=True)
    return paths


def _show_config(args: argparse.Namespace, parser: argparse.ArgumentParser) -> str:
    """Print the resolved configuration as JSON; returns it."""
    text = _load_config(args.config).to_json()
    print(text, flush=True)
    return text


def _serve_tracking(args: argparse.Namespace, parser: argparse.ArgumentParser) -> None:
    """Serve the tracking UI over the store at ``--root`` (the reference's
    ``mlflow_server_cmd.py``) until interrupted."""
    from downgan_tpu_torch.tracking.server import serve

    server = serve(args.root, args.host, args.port)
    print(f"tracking UI on http://{args.host}:{server.server_address[1]} (store: {args.root})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def _export_mlflow(args: argparse.Namespace, parser: argparse.ArgumentParser) -> list:
    """Export tracked runs (``--run``, or every run of ``--experiment``, or
    of every experiment) as an MLflow FileStore tree; returns the run
    directories written."""
    from downgan_tpu_torch.tracking.mlflow_export import export_experiment, export_run
    from downgan_tpu_torch.tracking.store import TrackingStore

    store = TrackingStore(args.tracking_root)
    written = []
    if args.run is not None:
        try:
            run = store.get_run(args.run)
        except KeyError as e:
            parser.error(str(e))
        if args.experiment is not None:
            # --experiment filters: a run of another experiment is refused.
            exp_id = store.experiment_by_name(args.experiment)
            if exp_id is None or run.experiment_id != exp_id:
                parser.error(f"run {args.run} does not belong to experiment "
                             f"{args.experiment!r} (it is in experiment id {run.experiment_id}); "
                             "drop --experiment or pick a run from that experiment")
        written.append(export_run(run, args.out, include_checkpoints=args.checkpoints))
    else:
        experiments = store.experiments()
        if args.experiment is not None:
            exp_id = store.experiment_by_name(args.experiment)
            if exp_id is None:
                parser.error(f"experiment {args.experiment!r} not found in {args.tracking_root} "
                             f"(have: {[i.get('name') for i in experiments.values()]})")
            exp_ids = [exp_id]
        else:
            exp_ids = list(experiments)
        for exp_id in exp_ids:
            written.extend(export_experiment(store, exp_id, args.out,
                                             include_checkpoints=args.checkpoints))
    if not written:
        parser.error(f"no runs to export under {args.tracking_root}")
    print(f"exported {len(written)} run(s) to MLflow FileStore {args.out}", flush=True)
    print(f"view: mlflow ui --backend-store-uri {os.path.abspath(args.out)}", flush=True)
    return written


def _export_torch(args: argparse.Namespace, parser: argparse.ArgumentParser) -> str:
    """Write a trained RRDB generator's reference-layout state dict (the
    inverse of ``import-torch``; upstream it loads into ``Generator(filters,
    fine, channels, preds, num_res_blocks=N)``); returns the file's path."""
    from downgan_tpu_torch.utils.port_weights import check_reference_layout

    config, path, weights_only, _ = _source(args, parser)
    try:
        check_reference_layout("export-torch", config.generator_arch)
    except ValueError as e:
        parser.error(str(e))
    if args.ema and weights_only:
        parser.error("an exported bundle holds ONE set of params (EMA already baked in if it "
                     "was exported with --ema); drop --ema, or export-torch from the full "
                     "Trainer checkpoint directory")
    if config.noise_channels > 0:
        # The reference layout has no latent: conv1 keeps covariates + noise
        # input channels, and import-torch makes a deterministic model of it.
        print(f"warning: stochastic generator (noise_channels={config.noise_channels}) — the "
              f"torch layout bakes the latent into conv1 ({config.n_covariates} covariates + "
              f"{config.noise_channels} noise input channels). Upstream, pass channels = "
              "covariates + noise and feed latents explicitly; re-importing via import-torch "
              "yields a DETERMINISTIC model expecting that widened input, not a drop-in "
              "--warm-start/--ensemble bundle.", file=sys.stderr, flush=True)
    weights = _restore(path, weights_only, args, parser)
    sd = {k: v.detach().cpu().contiguous() for k, v in weights.items()}
    torch.save(sd, args.out)
    print(f"exported {'EMA ' if args.ema else ''}generator ({len(sd)} tensors, reference torch "
          f"layout) to {args.out}", flush=True)
    return args.out


def _load_torch_weights(path: str, parser: argparse.ArgumentParser) -> dict:
    """A reference checkpoint's tensors: a bare state dict, or a pickled
    module (what the reference's MLflow logged each epoch)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 - not a plain state dict; try the pickled module
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except ModuleNotFoundError as e:
            parser.error(f"{path} is a pickled torch module and unpickling needs its defining "
                         f"package ({e.name}) importable — put the reference DoWnGAN checkout "
                         "on PYTHONPATH, or re-save the checkpoint as a bare state_dict "
                         "(torch.save(model.state_dict(), ...))")
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        parser.error(f"{path} is neither a state_dict nor a torch module")
    return {k: torch.as_tensor(v).detach().cpu() for k, v in obj.items()}


def _import_torch(args: argparse.Namespace, parser: argparse.ArgumentParser) -> str:
    """Import a reference (PyTorch DoWnGAN) checkpoint as a servable bundle:
    infer the architecture from the weights, check it with one real
    forward on ``--device``, and write the ``export`` layout (the port's
    networks use the reference keys, so the tensors pass through
    unchanged); returns the bundle directory."""
    from downgan_tpu_torch.inference import write_generator_bundle
    from downgan_tpu_torch.training.state import load_generator, make_critic, resolve_device
    from downgan_tpu_torch.utils.port_weights import (check_reference_layout, infer_critic_arch,
                                                      infer_generator_arch)

    sd = _load_torch_weights(args.weights, parser)
    try:
        arch = infer_generator_arch(sd)
        check_reference_layout("import-torch", sd=sd)
    except ValueError as e:
        parser.error(str(e))
    config = _load_config(args.config, args.region).replace(
        filters=arch["filters"], n_covariates=arch["n_covariates"],
        n_predictands=arch["n_predictands"], num_res_blocks=arch["num_res_blocks"],
        generator_arch="rrdb", noise_channels=0)
    sf = 2 ** arch["num_upsample"]
    csd = None
    if args.critic_weights:
        csd = _load_torch_weights(args.critic_weights, parser)
        try:
            carch = infer_critic_arch(csd)
        except ValueError as e:
            parser.error(str(e))
        if carch["n_predictands"] != arch["n_predictands"]:
            parser.error(f"critic takes {carch['n_predictands']} channels but the generator "
                         f"predicts {arch['n_predictands']} — not a matching (unconditional) "
                         "pair")
        config = config.replace(fine_size=carch["fine_size"],
                                coarse_size=carch["fine_size"] // sf, critic_conditional=False)
    else:
        config = config.replace(coarse_size=config.fine_size // sf)
    # One real forward of each network on the device (a mis-mapped key or a
    # wrong shape fails here, not at serve time).
    device = resolve_device(args.device)
    _fp32_without_tf32()
    gen = load_generator(config, sd, device)
    with torch.no_grad():
        fields = gen(torch.zeros((1, config.n_covariates, config.coarse_size,
                                  config.coarse_size), device=device))
    want = (1, config.n_predictands, config.fine_size, config.fine_size)
    if tuple(fields.shape) != want:
        parser.error(f"imported generator produces {tuple(fields.shape)}, expected {want}")
    if csd is not None:
        critic = make_critic(config, device)
        critic.load_state_dict(csd, strict=True)
        with torch.no_grad():
            critic(torch.zeros(want, device=device))
    out = write_generator_bundle(args.out, config, sd, c_weights=csd)
    n_g = sum(v.numel() for v in sd.values())
    print(f"imported generator ({arch['filters']} filters, {arch['num_res_blocks']} RRDBs, "
          f"{sf}x upsample, {n_g:,} params" + (", + critic" if csd is not None else "")
          + f") to {out}", flush=True)
    print(f"note: inferred n_covariates={arch['n_covariates']} is conv1's input width — for a "
          "checkpoint exported from a stochastic (noise_channels>0) model that width includes "
          "the baked-in noise channels, and the imported bundle is deterministic.", flush=True)
    return out


def _profile(args: argparse.Namespace, parser: argparse.ArgumentParser) -> dict:
    """Profile ``--steps`` train steps (or fused rounds, or generator
    forwards) on synthetic data into a Chrome trace under ``--out``; the
    warm-up step and the kernel's build happen before the trace. Prints one
    JSON line (the JAX command's keys, and ``patches_per_step``,
    ``generator_forwards``, ``drb_launches`` and ``device``) and returns its
    dict."""
    import contextlib

    from downgan_tpu_torch.utils import profiling

    if args.steps < 1:
        parser.error("--steps must be >= 1")
    config = _load_config(args.config, args.region)
    overrides = {k: getattr(args, k) for k in ("batch_size", "compute_dtype")
                 if getattr(args, k) is not None}
    if overrides:
        config = config.replace(hp=dataclasses.replace(config.hp, **overrides))
    device = torch.device(args.device)
    _fp32_without_tf32()
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(device)  # the peak of this run alone

    @contextlib.contextmanager
    def window():
        with contextlib.ExitStack() as stack:
            stack.enter_context(profiling.trace(args.out))
            if args.anomaly:
                stack.enter_context(profiling.detect_anomalies())
            stack.enter_context(profiling.annotate(f"profiled_{args.mode}_window"))
            yield

    check = profiling.check_finite if args.anomaly else None
    measure = profiling.measure_train if args.mode == "train" else profiling.measure_infer
    kw = {"census": False} if args.mode == "train" else {}
    rec = measure(config, args.steps, 1, device, window=window, check=check, **kw)
    fused = args.mode == "train" and config.hp.schedule == "fused"
    result = {"mode": args.mode, "steps": args.steps, "batch": config.hp.batch_size,
              "schedule": config.hp.schedule if args.mode == "train" else None,
              "steps_per_s": rec["steps_per_s"], "patches_per_s": rec["value"],
              "trace_dir": args.out, "hbm": profiling.device_memory_stats(device),
              "patches_per_step": config.hp.batch_size * (config.hp.critic_iterations
                                                          if fused else 1),
              "generator_forwards": rec["generator_forwards"],
              "drb_launches": rec["drb_launches"], "device": rec["device"]}
    print(json.dumps(result), flush=True)
    print(f"view: tensorboard --logdir {args.out} (or open the .pt.trace.json in "
          "chrome://tracing or Perfetto)", flush=True)
    return result


def _tune(args: argparse.Namespace, parser: argparse.ArgumentParser) -> dict:
    """Sweep (batch, dtype, schedule, grad_accum) candidates, each measured
    in its own process (``python -m downgan_tpu_torch.utils.profiling``),
    then the fast paths at the winner; print the report as one JSON line,
    write the recommended config (``--out``) and the sweep
    (``--sweep-out``); returns the report."""
    import subprocess

    import downgan_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(downgan_tpu_torch.__file__)))
    base = _load_config(args.config)

    def measure(batch, dtype, schedule="reference", grad_accum=1, **toggles):
        cmd = [sys.executable, "-m", "downgan_tpu_torch.utils.profiling", "--batch", str(batch),
               "--dtype", dtype, "--schedule", schedule, "--grad-accum", str(grad_accum),
               "--steps", str(args.scan_steps), "--reps", str(args.reps),
               "--device", args.device]
        cmd += ["--reuse-fake"] if toggles.get("reuse_fake") else []
        cmd += ["--fused-critic"] if toggles.get("fused_critic") else []
        # The user's model is measured, since the recommendation is written into it.
        cmd += ["--config", os.path.abspath(args.config)] if args.config else []
        cmd += ["--smoke"] if args.smoke else []
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        label = (f"b{batch} {dtype} {schedule}" + (f" accum{grad_accum}" if grad_accum > 1 else "")
                 + "".join(f" +{k}" for k, v in toggles.items() if v))
        print(f"measuring {label} ...", file=sys.stderr, flush=True)
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                                  timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(f"  {label}: TIMEOUT after {args.timeout}s", file=sys.stderr, flush=True)
            return None
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(f"  {label}: FAILED\n{proc.stderr[-2000:]}", file=sys.stderr, flush=True)
            return None
        rec = json.loads(lines[-1])
        rec.update(batch=batch, dtype=dtype, schedule=schedule, grad_accum=grad_accum,
                   **toggles)
        print(f"  {label}: {rec['value']:.1f} {rec['unit']}", file=sys.stderr, flush=True)
        return rec

    split = lambda text: [x.strip() for x in text.split(",") if x.strip()]  # noqa: E731
    # The (batch, grad_accum) grid is checked once, so a sweep that skips
    # everything names the divisibility rule, not phantom failures.
    combos = []
    for b in (int(x) for x in split(args.batches)):
        for ga in (int(x) for x in split(args.grad_accums)):
            if ga < 1 or b % ga:
                print(f"  b{b} accum{ga}: skipped (batch must divide into microbatches)",
                      file=sys.stderr, flush=True)
            else:
                combos.append((b, ga))
    if not combos:
        parser.exit(1, f"error: no runnable (batch, grad-accum) combination: every batch in "
                    f"--batches {args.batches!r} fails to divide by every value in "
                    f"--grad-accums {args.grad_accums!r}\n")
    candidates = [rec for schedule in split(args.schedules) for dtype in split(args.dtypes)
                  for b, ga in combos
                  if (rec := measure(b, dtype, schedule, grad_accum=ga)) is not None]
    if not candidates:
        parser.exit(1, "error: every candidate failed or timed out\n")
    best = max(candidates, key=lambda r: r["value"])
    if args.fast_paths:
        at = dict(batch=best["batch"], dtype=best["dtype"], schedule=best["schedule"],
                  grad_accum=best["grad_accum"])
        singles = {}
        for toggle in ("reuse_fake", "fused_critic"):
            rec = measure(**at, **{toggle: True})
            if rec is not None:
                candidates.append(rec)
                singles[toggle] = rec["value"]
        # Both together, when each wins alone.
        if all(singles.get(t, 0) > best["value"] for t in ("reuse_fake", "fused_critic")):
            rec = measure(**at, reuse_fake=True, fused_critic=True)
            if rec is not None:
                candidates.append(rec)
        best = max(candidates, key=lambda r: r["value"])
    recommended_hp = {"batch_size": best["batch"], "compute_dtype": best["dtype"],
                      "schedule": best["schedule"], "grad_accum": best["grad_accum"],
                      "metrics_reuse_fake": bool(best.get("reuse_fake")),
                      "fused_critic_pass": bool(best.get("fused_critic"))}
    ranked = sorted(candidates, key=lambda r: -r["value"])
    report = {"best": {k: best[k] for k in ("metric", "value", "unit", "batch", "dtype", "schedule",
                                            "grad_accum", "aggregate_patches_per_sec",
                                            "n_chips")},
              "recommended_hp": recommended_hp,
              "candidates": [{k: r[k] for k in ("metric", "value")} for r in ranked]}
    print(json.dumps(report), flush=True)
    if args.sweep_out:
        # Every candidate's whole record: rep times, FLOP census, share of peak.
        with open(args.sweep_out, "w") as f:
            json.dump({"sweep": ranked, "best": best["metric"]}, f, indent=1)
        print(f"full sweep written to {args.sweep_out}", file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(base.replace(hp=dataclasses.replace(base.hp, **recommended_hp)).to_json())
        print(f"recommended production config written to {args.out}", file=sys.stderr,
              flush=True)
    return report


def _non_negative_int(text: str) -> int:
    value = int(text)
    if value < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {value}")
    return value


def _add_source_args(sub: argparse.ArgumentParser, what: str) -> None:
    sub.add_argument("--config", default=None,
                     help="Config JSON (default: the bundle's or the run's logged config, "
                     "else the built-in florida Config).")
    sub.add_argument("-c", "--checkpoint", default=None,
                     help=f"Bundle directory or trainer checkpoint directory to {what} from.")
    sub.add_argument("--run", default=None,
                     help=f"Tracked run id to {what} from (its checkpoints and logged config).")
    sub.add_argument("--tracking-root", default="experiments")
    sub.add_argument("-e", "--epoch", type=int, default=None,
                     help="Checkpoint epoch (default: the latest; trainer checkpoints only).")
    sub.add_argument("--ema", action="store_true",
                     help="The EMA generator's weights (trained with hp.ema_decay > 0; "
                     "trainer checkpoints only).")


def build_parser() -> argparse.ArgumentParser:
    from downgan_tpu_torch.config.config import REGIONS

    parser = argparse.ArgumentParser(prog="python -m downgan_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser(
        "serve", help="Serve super-resolution inference over HTTP (POST .npy "
        "covariates to /v1/generate; GET /healthz, /metrics).")
    _add_source_args(serve, "serve")
    serve.add_argument("--weights", default=None,
                       help="Generator state dict (.pt): a bundle's generator.pt or the file "
                       "`export-torch` writes.")
    serve.add_argument("--weights-only", action="store_true",
                       help="--checkpoint is a generator weights file (generator.pt), as "
                       "--weights.")
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
    serve.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=True,
                       help="Split domain-request tiles over every visible card (more than "
                       "one; the fields are those of one card).")
    serve.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    serve.set_defaults(func=_serve)

    generate = sub.add_parser(
        "generate", help="Generate super-resolved fields from a trained generator and write "
        "them to a NetCDF (needs h5py).")
    _add_source_args(generate, "generate")
    generate.add_argument("--region", choices=sorted(REGIONS), default=None)
    generate.add_argument("--weights-only", action="store_true",
                          help="--checkpoint is a generator weights file (generator.pt).")
    generate.add_argument("-o", "--out", default=None,
                          help="Output NetCDF (default: generated.nc, or "
                          "<run artifacts>/generated_ds.nc under --run).")
    generate.add_argument("--synthetic", action="store_true",
                          help="Generate from synthetic covariates.")
    generate.add_argument("--raw-covariates", action="store_true",
                          help="Rebuild the standardized coarse covariates from the raw NetCDFs "
                          "(gen_fake_ds.py:92-144) instead of reading the preprocessed files.")
    generate.add_argument("--subset", choices=("train", "test"), default="test",
                          help="Which year-mask subset to generate for, raw or preprocessed.")
    generate.add_argument("--samples", type=int, default=100, help="Synthetic sample count.")
    generate.add_argument("--tile-rows", type=int, default=0,
                          help="Overlap-tile the lat axis for domains taller than the training "
                          "patch (0 = whole-field forward); the tiles split over every visible "
                          "card.")
    generate.add_argument("--overlap", type=int, default=8, help="Tile context rows per side.")
    generate.add_argument("--tile-cols", type=int, default=0,
                          help="Also overlap-tile the lon axis (0 = whole-width bands).")
    generate.add_argument("--tiles-per-dispatch", type=int, default=8,
                          help="Tiles folded into one generator dispatch.")
    generate.add_argument("--ensemble", type=int, default=0,
                          help="Generate this many members of a stochastic generator "
                          "(Config.noise_channels > 0); the NetCDF gains a leading member "
                          "dimension. Incompatible with tiling.")
    generate.add_argument("--streamed", action="store_true",
                          help="Write each generated chunk straight into the NetCDF (host memory "
                          "constant in the series length; the same file as without it). "
                          "Composes with --tile-rows and --ensemble.")
    generate.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    generate.set_defaults(func=_generate)

    evaluate = sub.add_parser(
        "evaluate", help="The test-set metric pass from a checkpoint over a whole split, "
        "printed as one JSON line.")
    _add_source_args(evaluate, "evaluate")
    evaluate.add_argument("--region", choices=sorted(REGIONS), default=None)
    evaluate.add_argument("--weights-only", action="store_true",
                          help="--checkpoint is a generator weights file; the Wass metric needs "
                          "the critic and is dropped with a warning.")
    evaluate.add_argument("--synthetic", action="store_true",
                          help="Evaluate on the synthetic dataset.")
    evaluate.add_argument("--samples", type=int, default=128, help="Synthetic sample count.")
    evaluate.add_argument("--split", choices=("train", "test"), default="test",
                          help="Which preprocessed split to evaluate.")
    evaluate.add_argument("--out", default=None,
                          help="Also write the JSON line to this file.")
    evaluate.add_argument("--ensemble", type=int, default=0,
                          help="Also score a K-member ensemble of a stochastic generator: fair "
                          "CRPS, spread, ensemble-mean and member MAE.")
    evaluate.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    evaluate.set_defaults(func=_evaluate)

    export = sub.add_parser(
        "export", help="Write a servable generator bundle (generator.pt + config.json) "
        "from a trainer checkpoint.")
    _add_source_args(export, "export")
    export.add_argument("-o", "--out", required=True, help="Output bundle directory (created).")
    export.set_defaults(func=_export)

    train = sub.add_parser(
        "train", help="Train the WGAN-GP and print the per-epoch train and test "
        "metric means, one JSON line each.")
    train.add_argument("--config", default=None,
                       help="Config JSON (default: the built-in florida Config).")
    train.add_argument("--region", choices=sorted(REGIONS), default=None)
    train.add_argument("--synthetic", action="store_true",
                       help="Train on the synthetic dataset (default: the config's data, "
                       "preprocessed or raw NetCDFs).")
    train.add_argument("--host-feed", action="store_true",
                       help="Keep the dataset in host RAM and feed batches through pinned "
                       "buffers and a copy stream (for sets too big for device memory). "
                       "Implies the per-step loop (hp.fused_epoch=False, "
                       "schedule='reference'); the trajectory matches device-resident "
                       "training bit for bit.")
    train.add_argument("--stream", action="store_true",
                       help="Leave the dataset on disk and read batches lazily from the "
                       "preprocessed NetCDFs (run `prepare-data` first). Implies the "
                       "per-step loop like --host-feed; the trajectory matches "
                       "device-resident training bit for bit.")
    train.add_argument("--samples", type=int, default=512, help="Synthetic sample count.")
    train.add_argument("--epochs", type=int, default=None,
                       help="Epochs (default: the config's hp.epochs).")
    train.add_argument("--batch-size", type=int, default=None,
                       help="Override the config's hp.batch_size.")
    train.add_argument("--lr", type=float, default=None, help="Override the config's hp.lr.")
    train.add_argument("--seed", type=int, default=None, help="Override the config's seed.")
    train.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default=None,
                       help="Override the config's hp.compute_dtype (parameters stay fp32).")
    train.add_argument("--schedule", choices=("reference", "fused"), default=None,
                       help="Generator-update schedule: reference parity (step %% n_critic) "
                       "or the fused n_critic round (overrides hp.schedule).")
    train.add_argument("--generator-arch", choices=("rrdb", "esrgan", "srresnet"), default=None,
                       help="Generator family: rrdb (the reference's ESRGAN model), esrgan "
                       "(ESRGAN's own dense blocks: growth 32, LeakyReLU 0.2; fp32) or "
                       "srresnet (its SRGAN-style variant); overrides the config's.")
    train.add_argument("--noise-channels", type=int, default=None,
                       help="Latent channels appended to the generator input (> 0: a "
                       "stochastic generator for probabilistic downscaling; 0: the "
                       "deterministic model); overrides the config's.")
    train.add_argument("--lr-schedule", choices=("constant", "cosine", "linear"), default=None,
                       help="LR decay shape (default constant = reference parity). Steps count "
                       "each network's own optimizer updates.")
    train.add_argument("--lr-warmup-steps", type=int, default=None,
                       help="Linear warmup from 0 over this many updates.")
    train.add_argument("--lr-decay-steps", type=int, default=None,
                       help="Total updates over which cosine/linear decay runs.")
    train.add_argument("--lr-final-factor", type=float, default=None,
                       help="End LR as a fraction of the config's lr (default 0).")
    train.add_argument("--augment-flips", action=argparse.BooleanOptionalAction, default=None,
                       help="Physics-aware augmentation: random per-sample lon/lat mirror "
                       "flips of the (coarse, fine) pair, negating the u/v wind component "
                       "the mirror reverses (training only).")
    train.add_argument("--grad-accum", type=int, default=None,
                       help="Split each update's batch into this many microbatches and "
                       "accumulate their gradients (one optimizer update; the peak "
                       "activation memory of a microbatch).")
    train.add_argument("--eof-lambda", type=float, default=None,
                       help="EOF-projection regularization weight on the generator objective "
                       "(hp.ncomp EOFs fit from the training fine fields).")
    train.add_argument("--critic-conditional", action=argparse.BooleanOptionalAction,
                       default=None,
                       help="Condition the critic on the covariates: every critic input is the "
                       "fine field with the nearest-upsampled coarse stack appended.")
    train.add_argument("--freq-sep", action=argparse.BooleanOptionalAction, default=None,
                       help="Frequency-separation training: the critic scores high-pass "
                       "residuals and the content loss compares the low-pass bands.")
    train.add_argument("--device", default="cuda",
                       help="Torch device (default cuda: under --multihost, this rank's card).")
    train.add_argument("--mesh", action=argparse.BooleanOptionalAction, default=True,
                       help="Data-parallel over every visible card. One process trains on "
                       "one card, so with more than one card visible and no --multihost "
                       "this is refused with the torchrun command to use; --no-mesh trains "
                       "on one card.")
    train.add_argument("--multihost", action="store_true",
                       help="Data-parallel training, one process per card: join the job "
                       "(torchrun's environment, or --coordinator/--num-processes/"
                       "--process-id), take this rank's rows of every global batch, average "
                       "gradients across the ranks; rank 0 tracks the run and writes the "
                       "checkpoints. Run the same command on every rank. Requires "
                       "--checkpoint-dir (a path every rank reads).")
    train.add_argument("--coordinator", default=None,
                       help="host:port of rank 0 (or a tcp:// or file:// URL) for --multihost "
                       "(omit under torchrun).")
    train.add_argument("--num-processes", type=int, default=None,
                       help="Ranks in the job for --multihost (omit under torchrun).")
    train.add_argument("--process-id", type=int, default=None,
                       help="This process's rank for --multihost (omit under torchrun).")
    train.add_argument("--experiment", default=None,
                       help="Experiment name (default downgan-tpu; with --interactive, picked "
                       "on stdin).")
    train.add_argument("--interactive", action="store_true",
                       help="Pick the experiment on stdin (unless --experiment names one) and "
                       "type a run description (the reference's prompts).")
    train.add_argument("--run-name", default=None)
    train.add_argument("--tracking-root", default="experiments")
    train.add_argument("--checkpoint-dir", default=None,
                       help="Checkpoint directory (default: <run artifacts>/checkpoints).")
    train.add_argument("--resume", action="store_true",
                       help="Resume from the latest checkpoint in the checkpoint directory.")
    train.add_argument("--warm-start", default=None,
                       help="Start the generator (and the critic, if the bundle has one) "
                       "from a bundle directory, with fresh optimizer state; its model-shape "
                       "fields, generator_arch and noise_channels override the config. A "
                       "successful --resume supersedes it.")
    train.add_argument("--save-every", type=int, default=None,
                       help="Checkpoint cadence in epochs (default: hp.save_every).")
    train.add_argument("--max-checkpoints", type=_non_negative_int, default=None,
                       help="Checkpoints retained (0 = keep every epoch, the reference's "
                       "behaviour; default: config.max_checkpoints).")
    train.add_argument("--keep-every", type=int, default=None,
                       help="Also keep every k-th epoch's checkpoint outside the retention "
                       "window (default: config.keep_checkpoint_every).")
    train.add_argument("--print-every", type=int, default=None,
                       help="Epoch-line cadence in epochs (default: hp.print_every).")
    train.add_argument("--plot-every", type=int, default=1,
                       help="Grid-figure cadence in epochs (needs matplotlib; without it the "
                       "figures are skipped with a note).")
    train.add_argument("--tensorboard", action="store_true",
                       help="Also log the epoch means to TensorBoard under <run "
                       "artifacts>/tensorboard (needs tensorboardX).")
    train.add_argument("--mlflow-dir", default=None,
                       help="Also mirror the run live into an MLflow FileStore at this root "
                       "(point `mlflow ui --backend-store-uri` at it); export-mlflow of the "
                       "finished run then changes nothing.")
    train.add_argument("--track-best", default=None, metavar="METRIC",
                       help="After each test pass that improves this test metric (e.g. "
                       "MSSSIM, MAE), write the serving weights (EMA when trained with "
                       "hp.ema_decay, else live) as a bundle under <artifacts>/best.")
    train.add_argument("--best-mode", choices=("max", "min"), default=None,
                       help="Improvement direction for --track-best (default: max for "
                       "MSSSIM, min for error metrics).")
    train.set_defaults(func=_train)

    prepare = sub.add_parser(
        "prepare-data", help="Run the preprocessing pipeline and write the 4 train/test "
        "NetCDFs into the config's proc_data_dir.")
    prepare.add_argument("--config", default=None,
                         help="Config JSON (default: the built-in florida Config).")
    prepare.add_argument("-r", "--region", choices=sorted(REGIONS), default=None)
    prepare.set_defaults(func=_prepare_data)

    covariates = sub.add_parser(
        "prepare-covariates", help="Write one standardized NetCDF per covariate for a "
        "region and split (validation standardized with the train statistics).")
    covariates.add_argument("--config", default=None,
                            help="Config JSON (default: the built-in florida Config).")
    covariates.add_argument("-r", "--region", choices=sorted(REGIONS), default=None)
    covariates.add_argument("-s", "--set", dest="which_set", choices=("train", "validation"),
                            default="train", help="Which split to write.")
    covariates.set_defaults(func=_prepare_covariates)

    show = sub.add_parser("show-config", help="Print the resolved configuration as JSON.")
    show.add_argument("--config", default=None,
                      help="Config JSON (default: the built-in florida Config).")
    show.set_defaults(func=_show_config)

    tracking = sub.add_parser("serve-tracking", help="Serve the tracking UI over a tracking "
                              "root (experiments, runs, metrics, artifacts).")
    tracking.add_argument("--root", default="experiments")
    tracking.add_argument("--host", default="0.0.0.0")
    tracking.add_argument("-p", "--port", type=int, default=5555)
    tracking.set_defaults(func=_serve_tracking)

    mlflow = sub.add_parser("export-mlflow", help="Export tracked runs as an MLflow FileStore "
                            "tree (meta.yaml, params/, metrics/, tags/, artifacts/).")
    mlflow.add_argument("--run", default=None,
                        help="Tracked run id (default: every run of --experiment, or of every "
                        "experiment).")
    mlflow.add_argument("--experiment", default=None,
                        help="Experiment name to export when --run is not given.")
    mlflow.add_argument("--tracking-root", default="experiments")
    mlflow.add_argument("-o", "--out", default="mlruns", help="MLflow FileStore root to write.")
    mlflow.add_argument("--checkpoints", action=argparse.BooleanOptionalAction, default=False,
                        help="Also copy the run's checkpoints/ subtree (full train states).")
    mlflow.set_defaults(func=_export_mlflow)

    export_torch = sub.add_parser(
        "export-torch", help="Write a trained RRDB generator as a reference-layout torch "
        "state_dict (.pt), the inverse of import-torch.")
    _add_source_args(export_torch, "export")
    export_torch.add_argument("-o", "--out", required=True, help="Output state_dict file (.pt).")
    export_torch.set_defaults(func=_export_torch)

    import_torch = sub.add_parser(
        "import-torch", help="Import a reference (PyTorch DoWnGAN) generator, and optionally its "
        "critic, as a servable bundle; the architecture is read off the weights.")
    import_torch.add_argument("--weights", required=True,
                              help="Reference generator checkpoint: a state_dict .pt/.pth or a "
                              "pickled Generator module.")
    import_torch.add_argument("--critic-weights", default=None,
                              help="Also import the critic (state_dict or pickled module), so "
                              "`train --warm-start` continues with it.")
    import_torch.add_argument("--config", default=None,
                              help="Base config for data paths and region; the model-shape "
                              "fields come from the weights.")
    import_torch.add_argument("-r", "--region", choices=sorted(REGIONS), default=None)
    import_torch.add_argument("-o", "--out", required=True,
                              help="Output bundle directory (created).")
    import_torch.add_argument("--device", default="cuda",
                              help="Device of the check forward (default cuda).")
    import_torch.set_defaults(func=_import_torch)

    profile = sub.add_parser(
        "profile", help="Profile train steps or generator forwards on synthetic data into a "
        "Chrome trace (warm-up outside it) that carries the program's phase spans "
        "(train.call, critic.update, generator.update, metric.pass, drb.backward and their "
        "parts); print steps/s, patches/s and device memory.")
    profile.add_argument("--config", default=None)
    profile.add_argument("--region", choices=sorted(REGIONS), default=None)
    profile.add_argument("--batch-size", type=int, default=None)
    profile.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default=None)
    profile.add_argument("--steps", type=int, default=10,
                         help="Profiled steps (fused rounds under the fused schedule), after a "
                         "warm-up step outside the trace.")
    profile.add_argument("--mode", choices=("train", "infer"), default="train",
                         help="The WGAN-GP train step, or the generator forward as served.")
    profile.add_argument("--out", default="profiles", help="Trace directory.")
    profile.add_argument("--anomaly", action="store_true",
                         help="Over the profiled window: autograd's anomaly mode with its NaN "
                         "check (a backward that returns NaN raises, naming the forward op), "
                         "and a check of each step's outputs (a NaN or Inf a forward made "
                         "raises FloatingPointError). Off again after the window.")
    profile.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    profile.set_defaults(func=_profile)

    tune = sub.add_parser(
        "tune", help="Sweep batch, dtype, schedule and grad_accum candidates, each measured in "
        "its own process, and recommend the fastest as a config.")
    tune.add_argument("--config", default=None,
                      help="Base config the recommendation is merged into (and measured on).")
    tune.add_argument("--batches", default="64,128,256", help="Candidate batch sizes.")
    tune.add_argument("--dtypes", default="bfloat16", help="Candidate compute dtypes.")
    tune.add_argument("--schedules", default="reference,fused",
                      help="Update schedules (reference: the step %% n_critic step; fused: one "
                      "round of critic_iterations critic updates and one G update).")
    tune.add_argument("--grad-accums", default="1",
                      help="hp.grad_accum candidates, crossed with the batches; a batch a "
                      "candidate does not divide is skipped for it.")
    tune.add_argument("--fast-paths", action=argparse.BooleanOptionalAction, default=True,
                      help="Also measure metrics_reuse_fake and fused_critic_pass at the winner "
                      "(and both, when each wins alone).")
    tune.add_argument("--scan-steps", type=int, default=30,
                      help="Steps (or rounds) in a timed window.")
    tune.add_argument("--reps", type=int, default=3, help="Timed windows; the median counts.")
    tune.add_argument("--timeout", type=int, default=1500, help="Per-candidate seconds.")
    tune.add_argument("--out", default=None,
                      help="Write the recommended config JSON here.")
    tune.add_argument("--sweep-out", default=None,
                      help="Write every candidate's whole record (rep times, FLOP census, "
                      "share of peak) as JSON.")
    tune.add_argument("--smoke", action="store_true",
                      help="The harness check: a tiny model (with --device cpu, on the CPU).")
    tune.add_argument("--device", default="cuda", help="Torch device (default cuda).")
    tune.set_defaults(func=_tune)
    return parser


def main(argv=None):
    """Run one subcommand; returns what it returns (``train``: the
    Trainer; ``export`` and ``import-torch``: the bundle directory;
    ``export-torch``: the file; ``generate``: the NetCDF's path;
    ``evaluate``, ``profile``, ``tune``: the JSON line's dict;
    ``prepare-data``, ``prepare-covariates``, ``export-mlflow``: the paths
    written; ``show-config``: the JSON text)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    return args.func(args, parser)


if __name__ == "__main__":
    main()
