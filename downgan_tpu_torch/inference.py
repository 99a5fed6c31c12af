"""Generator restore, servable bundles, chunked batch inference and
ensembles (counterpart of ``downgan_tpu/inference.py``:
``RestoreUsageError``, ``resolve_run_checkpoint``,
``restore_generator_params``, ``write_generator_bundle``, ``load_bundle``,
``generate_fields``, ``generate_ensemble`` and ``ensemble_metrics``; the
streaming iterator and NetCDF output come with a later slice).

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
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.ops.ensemble import crps_ensemble, ensemble_spread
from downgan_tpu_torch.training.state import load_generator, resolve_device
from downgan_tpu_torch.training.wgan import FIXED_LATENT_TAG
from downgan_tpu_torch.utils.checkpoint import CheckpointManager, load_params, save_params
from downgan_tpu_torch.utils.port_weights import load_generator_weights

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


def _generate(gen: torch.nn.Module, config: Config, coarse: np.ndarray, chunk: int,
              member: int, latent: Optional[LatentFn]) -> np.ndarray:
    dev = next(gen.parameters()).device
    k = config.noise_channels
    outs = []
    for i, start in enumerate(range(0, coarse.shape[0], chunk)):
        block = np.asarray(coarse[start:start + chunk], np.float32)
        n = block.shape[0]
        if n < chunk:
            block = np.concatenate([block, np.zeros((chunk - n, *block.shape[1:]), np.float32)])
        if k:
            shape = (chunk, *block.shape[1:3], k)
            z = (member_latent(config, member, i, shape) if latent is None
                 else np.asarray(latent(member, i, shape), np.float32))
            block = np.concatenate([block, z], axis=-1)
        with torch.inference_mode():
            x = torch.from_numpy(block).to(dev).permute(0, 3, 1, 2).contiguous()
            outs.append(gen(x)[:n].permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(outs, axis=0)


def generate_fields(config: Config, weights: Mapping[str, torch.Tensor],
                    coarse: np.ndarray, chunk_size: int = 0,
                    device: str | torch.device = "cuda", member: int = 0,
                    latent: Optional[LatentFn] = None) -> np.ndarray:
    """(N, h, w, C) coarse covariates -> (N, H, W, P) generated fields
    (NHWC both), with the generator's ``weights`` on ``device``.

    Runs a fixed chunk (``chunk_size=0``: ``config.chunk_size``) so every
    dispatch has one batch shape; the ragged tail is padded with zeros and
    trimmed after. A stochastic generator takes one latent block per chunk,
    padding rows included, :func:`member_latent` of ``(config.seed,
    member, chunk)`` (or ``latent``): the same call gives the same fields
    bit for bit, and another ``member`` an independent ensemble member. A
    deterministic generator ignores ``member``."""
    gen = load_generator(config, weights, device)
    return _generate(gen, config, coarse, chunk_size or config.chunk_size, member, latent)


def generate_ensemble(config: Config, weights: Mapping[str, torch.Tensor],
                      coarse: np.ndarray, n_members: int, chunk_size: int = 0,
                      device: str | torch.device = "cuda",
                      latent: Optional[LatentFn] = None) -> np.ndarray:
    """Probabilistic downscaling: the (M, N, H, W, P) stack of ``n_members``
    members of a stochastic generator, member m being
    :func:`generate_fields` with ``member=m``, from one loaded generator."""
    if config.noise_channels <= 0:
        raise ValueError(
            "ensemble generation needs a stochastic generator: train with "
            "Config.noise_channels > 0 (a deterministic generator returns "
            "identical members)")
    gen = load_generator(config, weights, device)
    chunk = chunk_size or config.chunk_size
    return np.stack([_generate(gen, config, coarse, chunk, m, latent)
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
