"""Weight mapping into the port (counterpart of the ``export_generator``
and ``export_critic`` half of ``downgan_tpu/utils/port_weights.py``).

The port's networks use the reference state-dict keys, which are also
what the JAX package's ``export-torch`` writes:
``conv1.*``, ``res_blocks.{i}.dense_blocks.{j}.b{k}.0.*``, ``conv2.*``,
``upsampling.{0,3,6}.*``, ``conv3.{0,2}.*`` for the generator;
``features.{0,2,...,14}.*`` (bias only at 0) and ``classifier.{0,2}.*``
for the critic. Flax conv kernels are HWIO; torch's are OIHW. The SRResNet
generator's keys are the port's own (``models/generator.py``), since the JAX
package exports the RRDB only.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from downgan_tpu_torch.utils.checkpoint import load_params


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


def srresnet_state_dict_from_flax(params: Mapping, num_res_blocks: int = 16,
                                  num_upsample: int = 3) -> Dict[str, torch.Tensor]:
    """Flax ``SRResNetGenerator`` variables (as numpy arrays) -> the port's
    :class:`~downgan_tpu_torch.models.generator.SRResNetGenerator` state
    dict. The 3x3 convs (``Conv3x3``) hold their kernel under ``Conv_0``;
    the 9x9 ``conv1`` and ``conv3`` are plain ``nn.Conv`` leaves; a PReLU's
    ``alpha`` (1,) is torch's ``weight`` (1,), the norm's ``scale`` and
    ``bias`` its ``weight`` and ``bias``."""
    p = params["params"] if "params" in params else params
    vec = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}
    sd.update(conv_from_flax(p["conv1"], "conv1"))
    sd["prelu1.weight"] = vec(p["prelu1"]["alpha"])
    for i in range(num_res_blocks):
        block = p[f"res{i}"]
        sd.update(conv_from_flax(block["conv1"]["Conv_0"], f"res_blocks.{i}.conv1"))
        sd[f"res_blocks.{i}.prelu.weight"] = vec(block["prelu"]["alpha"])
        sd.update(conv_from_flax(block["conv2"]["Conv_0"], f"res_blocks.{i}.conv2"))
    sd.update(conv_from_flax(p["conv2"]["Conv_0"], "conv2"))
    sd["bn2.weight"], sd["bn2.bias"] = vec(p["bn2"]["scale"]), vec(p["bn2"]["bias"])
    for u in range(num_upsample):
        sd.update(conv_from_flax(p[f"up{u}"]["Conv_0"], f"up{u}"))
        sd[f"up_prelu{u}.weight"] = vec(p[f"up_prelu{u}"]["alpha"])
    sd.update(conv_from_flax(p["conv3"], "conv3"))
    return sd


def _nchw_to_nhwc_flat_perm(c: int, h: int, w: int) -> np.ndarray:
    """Permutation p with flax_flat[i] = torch_flat[p[i]]: index by
    (h, w, c) NHWC order into the torch (c, h, w) flat layout (the JAX
    package's helper of the same name)."""
    idx = np.arange(c * h * w).reshape(c, h, w)
    return np.transpose(idx, (1, 2, 0)).reshape(-1)


def critic_state_dict_from_flax(params: Mapping, base: int = 16,
                                fine_size: int = 128) -> Dict[str, torch.Tensor]:
    """Flax ``Critic`` variables (as numpy arrays) -> the port's state dict;
    the same mapping as the JAX package's ``export_critic``. The flax fc1
    kernel's rows follow its NHWC flatten; torch flattens NCHW, so they are
    put back in torch order before the (in, out) -> (out, in) transpose."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for i in range(8):
        sd.update(conv_from_flax(p[f"conv{i}"]["Conv_0"], f"features.{2 * i}"))
    spatial = fine_size // 16
    perm = _nchw_to_nhwc_flat_perm(8 * base, spatial, spatial)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    for name, leaf, rows in (("classifier.0", p["fc1"], inv), ("classifier.2", p["fc2"], None)):
        kernel = np.asarray(leaf["kernel"], np.float32)
        if rows is not None:
            kernel = kernel[rows]
        sd[f"{name}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    return sd


def load_generator_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a generator state dict onto the CPU: a bundle's
    ``generator.pt`` (RRDB or SRResNet) or the file ``downgan_tpu.cli
    export-torch`` writes (RRDB), each a ``torch.save``d dict of tensors.
    Both families have a ``conv1.weight``; which one the keys must match
    is the config's ``generator_arch``, checked when they load."""
    sd = load_params(path)
    if not isinstance(sd, dict) or "conv1.weight" not in sd:
        raise ValueError(f"{path} is not a generator state_dict of either architecture, "
                         "RRDB or SRResNet (no conv1.weight)")
    return sd


def _shape(t) -> tuple:
    return tuple(t.shape)


def infer_generator_arch(sd: Mapping[str, Any]) -> Dict[str, int]:
    """The RRDB Generator's architecture read off a reference state dict
    (numpy arrays or tensors), so ``cli import-torch`` rebuilds the model
    without being told its shape (the reference stores it nowhere:
    ``networks/generator.py:10-24`` takes it as constructor arguments).

    Returns ``filters``, ``n_covariates``, ``n_predictands``,
    ``num_res_blocks`` and ``num_upsample``; raises a ``ValueError`` naming
    the missing key for a dict that is not a DoWnGAN Generator's (the JAX
    package's ``infer_generator_arch``, same messages)."""
    try:
        conv1 = _shape(sd["conv1.weight"])  # OIHW
        head = _shape(sd["conv3.2.weight"])
    except KeyError as e:
        raise ValueError(f"not a DoWnGAN Generator state_dict: missing key {e}") from e
    blocks = {int(k.split(".")[1]) for k in sd if k.startswith("res_blocks.")}
    ups = {int(k.split(".")[1]) for k in sd if k.startswith("upsampling.")}
    if not blocks or not ups:
        raise ValueError("not a DoWnGAN Generator state_dict: no res_blocks.*/"
                         "upsampling.* keys")
    # One conv per upsample stage at Sequential indices 0, 3, 6, ... (the
    # LeakyReLU and PixelShuffle slots between carry no parameters).
    if ups != {3 * u for u in range(len(ups))}:
        raise ValueError(f"unexpected upsampling conv indices {sorted(ups)} — not the "
                         "DoWnGAN Sequential layout (convs at 0, 3, 6, ...)")
    return {"filters": int(conv1[0]), "n_covariates": int(conv1[1]),
            "n_predictands": int(head[0]), "num_res_blocks": max(blocks) + 1,
            "num_upsample": len(ups)}


def check_reference_layout(command: str, generator_arch: str = "rrdb",
                           sd: Mapping[str, Any] | None = None) -> None:
    """``export-torch`` and ``import-torch`` map the reference RRDB layout
    only: DoWnGAN's dense blocks, which grow by ``filters`` channels a
    stage. Raises a ``ValueError`` that names it for another
    ``generator_arch``, or for a state dict ``sd`` whose first dense block
    grows by another width (ESRGAN's 32)."""
    first = "res_blocks.0.dense_blocks.0.b1.0.weight"
    if generator_arch == "rrdb" and sd is not None and first in sd and "conv1.weight" in sd:
        growth, filters = _shape(sd[first])[0], _shape(sd["conv1.weight"])[0]
        if growth != filters:
            raise ValueError(f"{command} maps the reference RRDB layout only (dense blocks "
                             f"growing by filters); this state dict's grow by {growth} "
                             f"channels at filters={filters} (generator_arch 'esrgan')")
    if generator_arch != "rrdb":
        raise ValueError(f"{command} maps the reference RRDB layout only (generator_arch "
                         f"'rrdb'); this model is generator_arch={generator_arch!r}")


def infer_critic_arch(sd: Mapping[str, Any]) -> Dict[str, int]:
    """The Critic's architecture read off a reference state dict
    (``networks/critic.py:9-40``): the base filter count and the predictand
    count from the first conv, ``fine_size`` from the first classifier
    layer's input width (``8 * base * (fine / 16)**2``); ``ValueError``s as
    the JAX package's ``infer_critic_arch``."""
    try:
        conv0 = _shape(sd["features.0.weight"])  # OIHW
        fc0 = _shape(sd["classifier.0.weight"])  # (out, in)
    except KeyError as e:
        raise ValueError(f"not a DoWnGAN Critic state_dict: missing key {e}") from e
    base = int(conv0[0])
    spatial = int(round((fc0[1] / (8 * base)) ** 0.5))
    if spatial * spatial * 8 * base != fc0[1]:
        raise ValueError(f"classifier.0 input width {fc0[1]} is not 8*{base}*s^2 for integer "
                         "s — not a DoWnGAN Critic layout")
    return {"filters": base, "n_predictands": int(conv0[1]), "fine_size": spatial * 16}
