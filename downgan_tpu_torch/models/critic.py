"""VGG-style WGAN critic, NCHW (counterpart of
``downgan_tpu/models/critic.py``).

Eight 3x3 convs with channel multipliers {1,1,2,2,4,4,8,8} x base and
strides {1,2} x 4 (spatial /16), LeakyReLU(0.2), then Linear(100) ->
LeakyReLU(0.2) -> Linear(1). Only the first conv has a bias. Florida:
(B, 2, 128, 128) -> (B, 1), 1,112,313 params.

Attribute names reproduce the reference state-dict keys
(``features.{0,2,...,14}``, ``classifier.{0,2}``), so a dict written by the
JAX package's ``export_critic`` loads with ``strict=True``. The flatten
before the classifier is torch's NCHW order; the JAX critic flattens NHWC,
and ``utils.port_weights.critic_state_dict_from_flax`` permutes the fc1
rows between the two.

The convs are ``layers.CriticConv2d``: where the input needs a gradient
(the gradient penalty's interpolate, the generator loss's fake), the GP's
double backward takes each conv's weight term as a weight gradient
(``convolution_backward``), not as stock autograd's convolution with a
kernel of the layer's whole output size.

``compute_dtype`` is the JAX ``Critic``'s ``dtype``: the input is cast to
it, every conv, activation and dense layer computes in it, the parameters
stay fp32 and the scores come back fp32.
"""
from __future__ import annotations

import torch
from torch import nn

from downgan_tpu_torch.models.layers import CRITIC_SLOPE, CriticConv2d, Linear


class Critic(nn.Module):
    """WGAN critic over fine-resolution fields. ``base`` is the reference's
    ``coarse_dim`` (the config's ``filters``); the classifier input width
    is ``8 * base * (fine_size / 16) ** 2``."""

    def __init__(self, base: int = 16, fine_size: int = 128, in_channels: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        specs = [(base, 1, True), (base, 2, False), (2 * base, 1, False), (2 * base, 2, False),
                 (4 * base, 1, False), (4 * base, 2, False), (8 * base, 1, False),
                 (8 * base, 2, False)]
        layers, cin = [], in_channels
        for feat, stride, bias in specs:
            layers += [CriticConv2d(cin, feat, kernel_size=3, stride=stride, padding=1,
                                    bias=bias, compute_dtype=compute_dtype),
                       nn.LeakyReLU(CRITIC_SLOPE)]
            cin = feat
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(8 * base * (fine_size // 16) ** 2, 100, compute_dtype=compute_dtype),
            nn.LeakyReLU(CRITIC_SLOPE), Linear(100, 1, compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        return self.classifier(self.features(x).flatten(1)).float()
