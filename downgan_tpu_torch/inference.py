"""Chunked batch inference (counterpart of ``generate_fields`` in
``downgan_tpu/inference.py``, deterministic generators only; ensembles,
NetCDF output and bundles come with later slices)."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.training.state import load_generator


def generate_fields(config: Config, weights: Mapping[str, torch.Tensor],
                    coarse: np.ndarray, chunk_size: int = 0,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """(N, h, w, C) coarse covariates -> (N, H, W, P) generated fields
    (NHWC both), with the generator's ``weights`` on ``device``.

    Runs a fixed chunk (``chunk_size=0``: ``config.chunk_size``) so every
    dispatch has one batch shape; the ragged tail is padded with zeros and
    trimmed after."""
    gen = load_generator(config, weights, device)
    dev = next(gen.parameters()).device
    chunk = chunk_size or config.chunk_size
    outs = []
    for start in range(0, coarse.shape[0], chunk):
        block = np.asarray(coarse[start:start + chunk], np.float32)
        n = block.shape[0]
        if n < chunk:
            block = np.concatenate([block, np.zeros((chunk - n, *block.shape[1:]), np.float32)])
        with torch.inference_mode():
            x = torch.from_numpy(block).to(dev).permute(0, 3, 1, 2).contiguous()
            outs.append(gen(x)[:n].permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(outs, axis=0)
