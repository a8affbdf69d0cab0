"""LPIPS-style perceptual distance on the device.

Port of ``celebrity_image_denoiser_tpu/metrics/perceptual.py::
PerceptualDistance`` (:35-146): per-layer unit-normalised feature
differences at relu1_2, relu2_2 and relu3_3 of ``models/vgg.py::
VGGFeatures``, averaged over space and channels, summed over the layers.
The tower comes from, in ``default()``'s order: a torchvision VGG16 ``.pth``
(``$CID_VGG_PTH``; ``from_torchvision_pth``), the shipped trained tower
``weights/perceptual`` (a denoising-autoencoder encoder trained in the repo,
section ``vgg``; ``from_npz``, ``input_domain="unit"``), or random features
(``pretrained`` False).  The tower also feeds srgan's content loss
(``train/losses.py::make_vgg_perceptual``).  Inputs are NHWC in [0, 1], as
the JAX function's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.models.vgg import VGGFeatures

# torchvision ImageNet normalisation (inputs arrive in [0, 1])
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
# the indices inside features[:16] after which the taps are taken: relu1_2,
# relu2_2, relu3_3
_TAPS = (3, 8, 15)
INPUT_DOMAINS = ("imagenet", "unit")


class PerceptualDistance:
    """``d(a, b)`` per image; ``a``, ``b`` NHWC in [0, 1]."""

    def __init__(self, net: Optional[VGGFeatures] = None, seed: int = 0,
                 input_domain: str = "imagenet"):
        """``net``: the tower (random features from ``seed`` without one);
        ``input_domain``: "imagenet" (torchvision weights, random features:
        the inputs get ImageNet's mean and std) or "unit" (the shipped
        tower, trained on raw [0, 1])."""
        if input_domain not in INPUT_DOMAINS:
            raise ValueError(f"unknown input_domain {input_domain!r}")
        self.pretrained = net is not None
        if net is None:
            net = VGGFeatures(generator=torch.Generator().manual_seed(seed))
        self.net = net.eval().requires_grad_(False)
        self.input_domain = input_domain

    def _taps(self, x: torch.Tensor):
        outs = []
        for i, layer in enumerate(self.net.slice):
            x = layer(x)
            if i in _TAPS:
                outs.append(x)
        return outs

    @torch.no_grad()
    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = (t.float().permute(0, 3, 1, 2) for t in (a, b))
        if self.input_domain == "imagenet":
            mean = torch.tensor(_MEAN, device=a.device).view(1, 3, 1, 1)
            std = torch.tensor(_STD, device=a.device).view(1, 3, 1, 1)
            a, b = (a - mean) / std, (b - mean) / std
        total = 0.0
        for xa, xb in zip(self._taps(a), self._taps(b)):
            na = xa * torch.rsqrt((xa * xa).sum(1, keepdim=True) + 1e-10)
            nb = xb * torch.rsqrt((xb * xb).sum(1, keepdim=True) + 1e-10)
            d = ((na - nb) ** 2).mean(dim=(2, 3))  # spatial average
            total = total + d.mean(dim=1)           # uniform layer weights
        return total

    @classmethod
    def from_torchvision_pth(cls, path: str) -> "PerceptualDistance":
        """A torchvision vgg16 ``.pth`` (``features.<i>.weight`` keys, or
        under ``state_dict`` / ``features``): its first 16 layers' convs.
        Raises if the file contributes no tower weight, so a wrong file
        cannot pass for a pretrained tower (``perceptual.py:103-108``), and,
        where the JAX importer would keep random weights, if it lacks one
        of the tower's."""
        sd = convert.load_pth_state_dict(path, ("state_dict", "features"))
        net = VGGFeatures()
        own = net.state_dict()
        loaded = {}
        for k, v in sd.items():
            name = ("slice." + k[len("features."):]
                    if k.startswith("features.") else k)
            if name in own:
                loaded[name] = v
        if "slice.0.weight" not in loaded:
            raise ValueError(
                f"{path} contributed no VGG feature weights (expected "
                "torchvision vgg16 'features.<i>.weight' keys)")
        missing = sorted(set(own) - set(loaded))
        if missing:
            raise ValueError(f"{path}: the VGG tower misses {missing}")
        net.load_state_dict(loaded, strict=True)
        return cls(net)

    @classmethod
    def from_npz(cls, path: str) -> "PerceptualDistance":
        """The native checkpoint directory with a ``vgg`` section (and
        ``vgg_state`` if any): the shipped trained tower, trained on [0, 1]."""
        net = VGGFeatures()
        net.load_state_dict(convert.load_npz_state_dict(path, "vgg", net),
                            strict=True)
        return cls(net, input_domain="unit")

    @classmethod
    def default(cls, seed: int = 0) -> "PerceptualDistance":
        """A trained tower when one is there, random features otherwise:
        ``$CID_VGG_PTH``, then ``weights/perceptual``, then random init
        (``pretrained`` False)."""
        pth = os.environ.get("CID_VGG_PTH")
        if pth and os.path.exists(pth):
            return cls.from_torchvision_pth(pth)
        from celebrity_image_denoiser_tpu_torch.core.config import (
            default_weights_dir,
        )

        npz = os.path.join(default_weights_dir(), "perceptual")
        if os.path.isdir(npz):
            return cls.from_npz(npz)
        return cls(seed=seed)
