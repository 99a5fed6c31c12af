"""Generator restore, servable bundles, batch inference to NetCDF and
ensembles (counterpart of ``downgan_tpu/inference.py``:
``RestoreUsageError``, ``resolve_run_checkpoint``,
``rebuild_coarse_covariates``, ``restore_generator_params``,
``write_generator_bundle``, ``load_bundle``, ``generate_fields``,
``generate_fields_iter``, ``generate_ensemble``, ``ensemble_metrics``,
``write_generated_netcdf`` and ``generate_to_netcdf``).

A stochastic generator's member latents are drawn on the host, one block
per chunk, by :func:`member_latent` of ``(config.seed, member, chunk)``:
the port's own stream (the JAX package folds the member and the chunk into
its threefry key), the same on the card and the CPU. Every function that
draws them takes ``latent=`` in its place, a function of ``(member, chunk,
shape)``, which is how parity tests pass the JAX package's draws in.

A bundle is a directory ``<dir>/generator.pt`` + ``<dir>/config.json``,
with an optional ``<dir>/critic.pt``. ``generator.pt`` is the reference-key
state dict that the JAX package's ``export-torch`` writes, so
``utils.port_weights.load_generator_weights`` reads both.

NetCDF output goes through ``h5py``, imported only where a file is opened;
:func:`generated_blocks` is the block source of the streamed writer and
runs without it.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.data.netcdf import write_netcdf
from downgan_tpu_torch.ops.ensemble import crps_ensemble, ensemble_spread
from downgan_tpu_torch.parallel.spatial import generator_replicas, tiled_generate
from downgan_tpu_torch.training.state import load_generator, resolve_device
from downgan_tpu_torch.training.wgan import FIXED_LATENT_TAG
from downgan_tpu_torch.utils.checkpoint import CheckpointManager, load_params, save_params
from downgan_tpu_torch.utils.port_weights import load_generator_weights
from downgan_tpu_torch.utils.profiling import annotate, spans_on

StateDict = Dict[str, torch.Tensor]
# latent(member, chunk index, NHWC shape) -> float32 array of that shape
LatentFn = Callable[[int, int, Tuple[int, ...]], np.ndarray]
GENERATOR_FILE, CRITIC_FILE, CONFIG_FILE = "generator.pt", "critic.pt", "config.json"


class RestoreUsageError(ValueError):
    """A restore refusal caused by contradictory user flags (``--epoch`` or
    ``--ema`` against a weights-only bundle, ``--ema`` on a run trained
    without EMA); the CLI reports these as usage errors."""


def _read_config(path: str) -> Config:
    with open(path) as f:
        return Config.from_json(f.read())


def resolve_run_checkpoint(tracking_root: str, run_id: str
                           ) -> Tuple[object, str, Optional[Config]]:
    """A tracked run id -> ``(run, checkpoint_dir, logged_config)``: the
    trainer's layout ``<run>/artifacts/checkpoints`` and the config the run
    logged at its start (``<run>/artifacts/config.json``), if any."""
    from downgan_tpu_torch.tracking.store import TrackingStore

    run = TrackingStore(tracking_root).get_run(run_id)
    ckpt_dir = os.path.join(run.artifact_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"run {run_id} has no checkpoints under {ckpt_dir}; "
                                "was it trained with a checkpoint manager?")
    cfg_path = os.path.join(run.artifact_dir, CONFIG_FILE)
    return run, ckpt_dir, _read_config(cfg_path) if os.path.exists(cfg_path) else None


def rebuild_coarse_covariates(config: Config, subset: str = "test"
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The standardized coarse covariate stack rebuilt from the raw NetCDFs
    (the reference's ``mask_and_standardize_coarse``,
    ``gen_fake_ds.py:92-144``): the subset's times (test = the complement
    of the train year-mask), the first WRF field dropped (``sel[0] =
    False``, ``gen_fake_ds.py:101``), each covariate standardized over the
    selected subset itself, the land-sea mask passed through, stacked in
    registry order. Returns ``(coarse, times)``: NHWC float32 and the
    selected times."""
    from downgan_tpu_torch.config.config import COVARIATE_NAMES_ORDERED
    from downgan_tpu_torch.data.pipeline import standardize_all, to_nhwc
    from downgan_tpu_torch.data.staging import _check_same_grid, load_covariates, load_fine
    from downgan_tpu_torch.data.times import filter_times

    if subset not in ("train", "test"):
        raise ValueError(f"subset must be 'train' or 'test', got {subset!r}")
    times = None
    if config.fine_paths:
        _, times = load_fine(config)
    if times is None:
        times = np.asarray(config.range_datetimes)
    cov = load_covariates(config, len(times))
    n_times = min(len(times), next(iter(cov.values())).shape[0])
    times = times[:n_times]

    train_mask = filter_times(times, mask_years=config.mask_years)
    sel = train_mask.copy() if subset == "train" else ~train_mask
    sel[0] = False
    standardized, _ = standardize_all({k: v[:n_times][sel] for k, v in cov.items()})
    _check_same_grid(standardized, "covariate")
    coarse = np.stack([standardized[k] for k in COVARIATE_NAMES_ORDERED], axis=1)
    return to_nhwc(coarse).astype(np.float32), times[sel]


def restore_generator_params(checkpoint: str, step: Optional[int] = None,
                             weights_only: bool = False, use_ema: bool = False) -> StateDict:
    """Generator weights (reference-key state dict, on the CPU) from a
    trainer checkpoint directory (epoch ``step``, default the latest;
    the EMA generator with ``use_ema``) or, with ``weights_only``, from a
    weights file (a bundle's ``generator.pt``, an ``export-torch`` file),
    which holds one set of weights and takes neither ``step`` nor
    ``use_ema``."""
    if weights_only:
        if step is not None:
            raise RestoreUsageError(
                "weights-only checkpoints (and exported bundles) hold a single set of params "
                "— an epoch/step cannot be selected. Use the full Trainer checkpoint "
                "directory to restore a specific epoch.")
        if use_ema:
            raise RestoreUsageError(
                "weights-only checkpoints (and exported bundles) hold one set of params — if "
                "the bundle was exported with --ema those already ARE the EMA weights; drop "
                "--ema (restore EMA from the full Trainer checkpoint directory instead)")
        return load_generator_weights(checkpoint)
    state = CheckpointManager(checkpoint).restore(step)
    if use_ema:
        if state["g_ema"] is None:
            raise RestoreUsageError("checkpoint has no EMA weights (hp.ema_decay was 0)")
        return state["g_ema"]
    return state["generator"]


def write_generator_bundle(out_dir: str, config: Config, g_weights: Mapping[str, torch.Tensor],
                           c_weights: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """Write a servable bundle: ``generator.pt`` (reference keys, CPU
    tensors), ``config.json`` and, given ``c_weights``, ``critic.pt``,
    which ``train --warm-start`` picks up. Re-saving replaces the bundle
    whole: a stale ``critic.pt`` is removed. Returns the directory."""
    out = os.path.abspath(out_dir)
    os.makedirs(out, exist_ok=True)
    host = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    save_params(os.path.join(out, GENERATOR_FILE), host(g_weights))
    c_path = os.path.join(out, CRITIC_FILE)
    if c_weights is not None:
        save_params(c_path, host(c_weights))
    elif os.path.exists(c_path):
        os.remove(c_path)
    with open(os.path.join(out, CONFIG_FILE), "w") as f:
        f.write(config.to_json())
    return out


def is_bundle(path: Optional[str]) -> bool:
    """Whether ``path`` is a bundle directory (``generator.pt`` +
    ``config.json``)."""
    return bool(path) and all(os.path.isfile(os.path.join(path, name))
                              for name in (GENERATOR_FILE, CONFIG_FILE))


def load_bundle(bundle_dir: str) -> Tuple[Config, StateDict, Optional[StateDict]]:
    """``(config, generator weights, critic weights or None)`` of a bundle,
    on the CPU."""
    if not is_bundle(bundle_dir):
        raise FileNotFoundError(f"{bundle_dir} is not a bundle directory (expected "
                                f"{GENERATOR_FILE} + {CONFIG_FILE}, the `export` layout)")
    c_path = os.path.join(bundle_dir, CRITIC_FILE)
    return (_read_config(os.path.join(bundle_dir, CONFIG_FILE)),
            load_generator_weights(os.path.join(bundle_dir, GENERATOR_FILE)),
            load_params(c_path) if os.path.exists(c_path) else None)


def member_latent(config: Config, member: int, chunk: int, shape: Tuple[int, ...]) -> np.ndarray:
    """Member ``member``'s latent for chunk ``chunk``, NHWC ``shape``
    float32: ``np.random.default_rng((seed, 0x5E11, member,
    chunk)).standard_normal(shape)``, a pure function of the four."""
    rng = np.random.default_rng((config.seed, FIXED_LATENT_TAG, member, chunk))
    return rng.standard_normal(shape).astype(np.float32)


def sample_latent(config: Config, index: int, shape: Tuple[int, ...]) -> np.ndarray:
    """The whole-domain latent of sample ``index`` of a streamed tiled
    series, NHWC ``shape`` float32: ``np.random.default_rng((seed, 0x5E11,
    index)).standard_normal(shape)``, the JAX package's draw
    (``inference.py:505-515``), so it depends on the sample, not on the
    chunking."""
    rng = np.random.default_rng((config.seed, FIXED_LATENT_TAG, index))
    return rng.standard_normal(shape).astype(np.float32)


def _chunks(gen: torch.nn.Module, config: Config, coarse: np.ndarray, chunk: int, member: int,
            latent: Optional[LatentFn]) -> Iterator[Tuple[int, np.ndarray]]:
    """``(start, (k, H, W, P))`` blocks of ``gen`` over ``coarse`` in fixed
    chunks, the ragged tail padded and trimmed. Each chunk's host
    preparation and copy in is a ``generate.h2d`` span, the forward
    ``generate.forward``, the copy back ``generate.copy_back``, and the
    caller's time holding the block ``generate.consumer``: adjacent spans,
    so the host's time between them is the profiler's alone."""
    dev = next(gen.parameters()).device
    k = config.noise_channels
    for i, start in enumerate(range(0, coarse.shape[0], chunk)):
        with annotate("generate.h2d"):
            block = np.asarray(coarse[start:start + chunk], np.float32)
            n = block.shape[0]
            if n < chunk:
                block = np.concatenate([block, np.zeros((chunk - n, *block.shape[1:]),
                                                        np.float32)])
            if k:
                shape = (chunk, *block.shape[1:3], k)
                z = (member_latent(config, member, i, shape) if latent is None
                     else np.asarray(latent(member, i, shape), np.float32))
                block = np.concatenate([block, z], axis=-1)
            x = torch.from_numpy(block).to(dev).permute(0, 3, 1, 2).contiguous()
        with annotate("generate.forward"), torch.inference_mode():
            y = gen(x)
        with annotate("generate.copy_back"), torch.inference_mode():
            out = y[:n].permute(0, 2, 3, 1).cpu().numpy()
            del y  # the block's device output is not held while the caller has it
        with annotate("generate.consumer"):
            yield start, out


def generate_fields_iter(config: Config, weights: Mapping[str, torch.Tensor],
                         coarse: np.ndarray, chunk_size: int = 0,
                         device: str | torch.device = "cuda", member: int = 0,
                         latent: Optional[LatentFn] = None) -> Iterator[Tuple[int, np.ndarray]]:
    """Chunked generation as an iterator of ``(start, (k, H, W, P))``
    blocks, with the generator's ``weights`` on ``device``: the loop of
    :func:`generate_fields`, one output block in host memory at a time.

    Every dispatch has one batch shape (``chunk_size=0``:
    ``config.chunk_size``); the ragged tail is padded with zeros and
    trimmed. A stochastic generator takes one latent block per chunk,
    padding rows included, :func:`member_latent` of ``(config.seed,
    member, chunk)`` (or ``latent``): the same call gives the same fields
    bit for bit, and another ``member`` an independent ensemble member. A
    deterministic generator ignores ``member``.

    Spans: the load is ``generate.load``, then :func:`_chunks`' spans, the
    caller's time holding each block ``generate.consumer`` among them. Two
    counters, always on, process-wide and never reset (as
    ``drb_forward.launches``):
    ``generate_fields_iter.chunks``, the blocks yielded, and
    ``generate_fields_iter.consumer_s``, the host seconds the callers held
    them (two ``time.perf_counter()`` reads a chunk), less a hold across
    which a profiler session started or stopped: that time is the
    profiler's start-up or export, not the caller's work on the block."""
    with annotate("generate.load"):
        gen = load_generator(config, weights, device)
    for item in _chunks(gen, config, coarse, chunk_size or config.chunk_size, member, latent):
        with _count_lock:
            generate_fields_iter.chunks += 1
        t0, traced = time.perf_counter(), spans_on()
        yield item
        if spans_on() == traced:
            held = time.perf_counter() - t0
            with _count_lock:
                generate_fields_iter.consumer_s += held


_count_lock = threading.Lock()
generate_fields_iter.chunks = 0
generate_fields_iter.consumer_s = 0.0


def generate_fields(config: Config, weights: Mapping[str, torch.Tensor],
                    coarse: np.ndarray, chunk_size: int = 0,
                    device: str | torch.device = "cuda", member: int = 0,
                    latent: Optional[LatentFn] = None) -> np.ndarray:
    """(N, h, w, C) coarse covariates -> (N, H, W, P) generated fields
    (NHWC both): :func:`generate_fields_iter`'s blocks, concatenated."""
    return np.concatenate([block for _, block in generate_fields_iter(
        config, weights, coarse, chunk_size, device, member, latent)], axis=0)


def _require_stochastic(config: Config) -> None:
    if config.noise_channels <= 0:
        raise ValueError(
            "ensemble generation needs a stochastic generator: train with "
            "Config.noise_channels > 0 (a deterministic generator returns "
            "identical members)")


def generate_ensemble(config: Config, weights: Mapping[str, torch.Tensor],
                      coarse: np.ndarray, n_members: int, chunk_size: int = 0,
                      device: str | torch.device = "cuda",
                      latent: Optional[LatentFn] = None) -> np.ndarray:
    """Probabilistic downscaling: the (M, N, H, W, P) stack of ``n_members``
    members of a stochastic generator, member m being
    :func:`generate_fields` with ``member=m``, from one loaded generator."""
    _require_stochastic(config)
    gen = load_generator(config, weights, device)
    chunk = chunk_size or config.chunk_size
    return np.stack([np.concatenate([b for _, b in _chunks(gen, config, coarse, chunk, m, latent)])
                     for m in range(n_members)])


@torch.no_grad()
def ensemble_metrics(config: Config, weights: Mapping[str, torch.Tensor], coarse: np.ndarray,
                     fine: np.ndarray, n_members: int, chunk_size: int = 0,
                     device: str | torch.device = "cuda",
                     latent: Optional[LatentFn] = None) -> Dict[str, float]:
    """Probabilistic verification of a stochastic generator on a split,
    scored on ``device``: the fair CRPS of :func:`generate_ensemble`'s
    members against ``fine`` (N, H, W, P), the mean spread (ddof 1), the
    MAE of the ensemble mean and of member 0, and ``n_members``. CRPS
    below the single-member MAE means the latent spread carries
    information."""
    members = generate_ensemble(config, weights, coarse, n_members, chunk_size=chunk_size,
                                device=device, latent=latent)
    dev = resolve_device(device)
    ens = torch.from_numpy(members).to(dev)
    truth = torch.from_numpy(np.asarray(fine, np.float32)).to(dev)
    return {"CRPS": float(crps_ensemble(ens, truth)),
            "spread": float(ensemble_spread(ens)),
            "ens_mean_MAE": float((ens.mean(dim=0) - truth).abs().mean()),
            "member_MAE": float((ens[0] - truth).abs().mean()),
            "n_members": n_members}


def _generated_layout(n: int, fine_h: int, fine_w: int, p: int, var_names: Sequence[str],
                      times: Optional[np.ndarray], lats: Optional[np.ndarray],
                      lons: Optional[np.ndarray], time_chunk: int, n_members: int = 0):
    """The NetCDF layout of generated fields, ``(names, coords, dims,
    chunks, shapes)``: the one source of :func:`write_generated_netcdf` and
    the streamed :func:`generate_to_netcdf`, so their files cannot drift
    apart. An ensemble's ``member`` dimension comes first."""
    if len(var_names) < p:
        raise ValueError(
            f"{p} predictand channels but only {len(var_names)} variable "
            f"names {tuple(var_names)} — every generated channel must be "
            "named (silently truncating would drop data from the file)")
    names = list(var_names[:p])
    coords: Dict[str, np.ndarray] = {
        "time": np.arange(n) if times is None else np.asarray(times).astype("float64"),
        "lat": np.arange(fine_h, dtype=np.float64) if lats is None else np.asarray(lats),
        "lon": np.arange(fine_w, dtype=np.float64) if lons is None else np.asarray(lons),
    }
    shape = (n, fine_h, fine_w)
    base_dims = ("time", "lat", "lon")
    chunk = (min(time_chunk, n), fine_h, fine_w)
    if n_members:
        coords["member"] = np.arange(n_members, dtype=np.float64)
        shape = (n_members, *shape)
        base_dims = ("member", *base_dims)
        chunk = (1, *chunk)
    return (names, coords, {name: base_dims for name in names},
            {name: chunk for name in names}, {name: shape for name in names})


def write_generated_netcdf(path: str, fields: np.ndarray,
                           var_names: Sequence[str] = ("u10", "v10"),
                           times: Optional[np.ndarray] = None, lats: Optional[np.ndarray] = None,
                           lons: Optional[np.ndarray] = None, time_chunk: int = 5) -> None:
    """Write generated (N, H, W, P) fields as a NetCDF of per-variable
    (time, lat, lon) arrays (``gen_fake_ds.py:162``'s chunked
    ``to_netcdf``); an ensemble stack (M, N, H, W, P) gains a leading
    ``member`` dimension."""
    m, (n, h, w, p) = (fields.shape[0], fields.shape[1:]) if fields.ndim == 5 else (0, fields.shape)
    names, coords, dims, chunks, _ = _generated_layout(n, h, w, p, var_names, times, lats, lons,
                                                       time_chunk, n_members=m)
    write_netcdf(path, {name: fields[..., i] for i, name in enumerate(names)}, dims,
                 coords=coords, chunks=chunks)


def generated_blocks(config: Config, weights: Mapping[str, torch.Tensor], coarse: np.ndarray,
                     chunk_size: int = 0, n_members: int = 0, tile_rows: int = 0,
                     overlap: int = 8, tile_cols: int = 0, tiles_per_dispatch: int = 8,
                     device: str | torch.device = "cuda",
                     devices: Optional[Sequence[str | torch.device]] = None,
                     latent: Optional[LatentFn] = None
                     ) -> Iterator[Tuple[Optional[int], int, np.ndarray]]:
    """The blocks of a streamed generation as ``(member, start, block)``,
    one fixed-size chunk of the series at a time, in one of three modes:

    * plain: :func:`generate_fields_iter`'s chunks (``member`` None);
    * ``tile_rows > 0``: each chunk overlap-tiled (``parallel.spatial``,
      over a replica on each of ``devices``, default ``[device]``); a
      stochastic generator's whole-domain latent for sample j is
      :func:`sample_latent` of its absolute index, so the fields do not
      depend on the chunking (an input that carries its latent channels
      already is tiled as it is);
    * ``n_members > 0``: every member's chunks in turn, member by member.

    The arguments are checked here, before the first block: an ensemble
    needs a stochastic generator and cannot be tiled."""
    if n_members and tile_rows:
        raise ValueError("ensemble streaming and tiled streaming are mutually exclusive "
                         "(tiled inference draws one whole-domain latent per sample)")
    if n_members:
        _require_stochastic(config)
    chunk = chunk_size or config.chunk_size

    def tiled() -> Iterator[Tuple[Optional[int], int, np.ndarray]]:
        gens = generator_replicas(config, weights, devices or [device])
        n, h, w, c = coarse.shape
        k = config.noise_channels
        for start in range(0, n, chunk):
            block = np.asarray(coarse[start:start + chunk], np.float32)
            if k and c == config.n_covariates:
                z = np.stack([sample_latent(config, start + j, (h, w, k))
                              for j in range(block.shape[0])])
                block = np.concatenate([block, z], axis=-1)
            yield None, start, tiled_generate(gens, config, block, tile_rows=tile_rows,
                                              overlap=overlap, tile_cols=tile_cols,
                                              tiles_per_dispatch=tiles_per_dispatch)

    def chunked() -> Iterator[Tuple[Optional[int], int, np.ndarray]]:
        gen = load_generator(config, weights, device)
        for m in range(n_members) if n_members else (None,):
            for start, block in _chunks(gen, config, coarse, chunk, m or 0, latent):
                yield m, start, block

    return tiled() if tile_rows else chunked()


def generate_to_netcdf(path: str, config: Config, weights: Mapping[str, torch.Tensor],
                       coarse: np.ndarray, var_names: Sequence[str] = ("u10", "v10"),
                       times: Optional[np.ndarray] = None, lats: Optional[np.ndarray] = None,
                       lons: Optional[np.ndarray] = None, chunk_size: int = 0,
                       n_members: int = 0, time_chunk: int = 5, tile_rows: int = 0,
                       overlap: int = 8, tile_cols: int = 0, tiles_per_dispatch: int = 8,
                       device: str | torch.device = "cuda",
                       devices: Optional[Sequence[str | torch.device]] = None,
                       latent: Optional[LatentFn] = None) -> None:
    """Generate straight into a NetCDF, one chunk of output in host memory
    at a time, for series whose whole (N, H, W, P) output would not fit
    (the in-memory path and the reference, ``gen_fake_ds.py:156-162``,
    hold all of it). The file holds what :func:`generate_fields` (or
    :func:`generate_ensemble`) and :func:`write_generated_netcdf` write,
    bit for bit; the tiled mode's latents are :func:`generated_blocks`'.
    The arguments are checked before the file is opened: h5py's ``"w"``
    truncates it."""
    from downgan_tpu_torch.data.netcdf import NetCDFStreamWriter

    blocks = generated_blocks(config, weights, coarse, chunk_size=chunk_size,
                              n_members=n_members, tile_rows=tile_rows, overlap=overlap,
                              tile_cols=tile_cols, tiles_per_dispatch=tiles_per_dispatch,
                              device=device, devices=devices, latent=latent)
    n, h, w, _ = coarse.shape
    sf = 2 ** config.num_upsample
    names, coords, dims, chunks, shapes = _generated_layout(
        n, h * sf, w * sf, config.n_predictands, var_names, times, lats, lons, time_chunk,
        n_members=n_members)
    with NetCDFStreamWriter(path, shapes, dims, coords=coords, chunks=chunks) as writer:
        for member, start, block in blocks:
            sel = slice(start, start + block.shape[0])
            for i, name in enumerate(names):
                writer.write(name, sel if member is None else (member, sel), block[..., i])
