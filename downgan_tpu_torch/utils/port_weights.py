"""Weight mapping into the port (counterpart of the generator half of
``downgan_tpu/utils/port_weights.py``).

The port's generator uses the reference state-dict keys, which are also
what the JAX package's ``export-torch`` writes:
``conv1.*``, ``res_blocks.{i}.dense_blocks.{j}.b{k}.0.*``, ``conv2.*``,
``upsampling.{0,3,6}.*``, ``conv3.{0,2}.*``. Flax conv kernels are HWIO;
torch's are OIHW.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def conv_from_flax(leaf: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One flax conv leaf ``{'kernel': HWIO, 'bias'}`` -> ``{prefix.weight:
    OIHW, prefix.bias}`` tensors."""
    out = {f"{prefix}.weight": torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(leaf["kernel"], np.float32), (3, 2, 0, 1))))}
    if "bias" in leaf:
        out[f"{prefix}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    return out


def generator_state_dict_from_flax(params: Mapping, num_res_blocks: int = 16,
                                   num_upsample: int = 3) -> Dict[str, torch.Tensor]:
    """Flax ``Generator`` variables (as numpy arrays) -> the port's state
    dict; the same mapping as the JAX package's ``export_generator``."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    sd.update(conv_from_flax(p["conv1"]["Conv_0"], "conv1"))
    for i in range(num_res_blocks):
        for j in range(3):
            for k in range(1, 6):
                sd.update(conv_from_flax(p[f"rrdb{i}"][f"drb{j}"][f"b{k}"]["Conv_0"],
                                         f"res_blocks.{i}.dense_blocks.{j}.b{k}.0"))
    sd.update(conv_from_flax(p["conv2"]["Conv_0"], "conv2"))
    for u in range(num_upsample):
        # torch Sequential indices: conv at 0, 3, 6 (LeakyReLU/PixelShuffle between)
        sd.update(conv_from_flax(p[f"up{u}"]["Conv_0"], f"upsampling.{3 * u}"))
    sd.update(conv_from_flax(p["head1"]["Conv_0"], "conv3.0"))
    sd.update(conv_from_flax(p["head2"]["Conv_0"], "conv3.2"))
    return sd


def load_generator_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a generator state dict written by ``downgan_tpu.cli
    export-torch`` (a ``torch.save``d dict of tensors) onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or "conv1.weight" not in sd:
        raise ValueError(f"{path} is not a DoWnGAN generator state_dict "
                         "(no conv1.weight)")
    return sd
