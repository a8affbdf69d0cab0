"""What the generators of the dncnn, esrgan and srgan families share: the
routes through their 3×3 convs, with each eval BatchNorm folded into the
conv before it.

``forward(x, route=...)``, as ``models/denoise_unet.py``'s:

* ``"kernel"`` (default) — every 3×3 stride-1 conv on the hand-written
  kernels (``ops/cuda``: K3 ``double_conv3x3_relu`` for a conv+ReLU pair,
  K2 ``conv3x3_bias_relu`` for one conv), with the eval BatchNorm after it
  folded in (``ops/norm.py::fold_batch_norm``), on NHWC tensors;
* ``"plain"`` — the same folded weights through the kernels' plain
  versions, the reference ``chip_smoke.py`` holds the kernel route against
  on the card;
* ``"autograd"`` — the modules in the JAX order (conv, then BatchNorm,
  then the activation), through ``ops/conv.py``: the route int8
  calibration hooks and replays (``ops/quant.py``) and a trainer uses.

The kernel and plain routes need eval mode (the fold takes the running
statistics) and refuse autograd.  The 9×9 heads and tails, PReLU, the
residual adds, PixelShuffle and tanh are PyTorch ops on every route, as
they were XLA ops in the JAX package.  The 9×9 heads take their input in
contiguous NCHW memory: the server hands the models an NHWC tensor's
NCHW view (channels-last memory), and for it cuDNN chose another
algorithm for a short tile (33 rows of a 4097-row input) than for the
whole image, whose sums rounded differently; the int8 rungs' s8
quantization turned those roundings into steps, and a tiled int8 request
differed from the untiled one by up to 3 counts.  In NCHW memory cuDNN
gave the same sums at every tile shape tried on the H100.  The folded,
kernel-layout weights (HWIO in the activation dtype, f32 bias) are made
once per loaded weights and rebuilt only when a parameter or statistic
changes; in float32 so is the f32 kernels' split, K-major copy of each
weight (``conv3x3.tf32_weights``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3, double_conv
from celebrity_image_denoiser_tpu_torch.ops.norm import fold_batch_norm

ROUTES = ("kernel", "plain", "autograd")


class FoldedConvNet(nn.Module):
    """Base of the generators whose 3×3 convs the kernel route runs with
    their BatchNorm folded in."""

    def __init__(self):
        super().__init__()
        # not part of the state_dict
        self._kparams: Dict[Tuple[str, torch.dtype], tuple] = {}

    def _check_route(self, route: str, x: torch.Tensor) -> None:
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choose from {ROUTES}")
        if route == "autograd":
            return
        if self.training:
            raise ValueError(f"route={route!r} folds the eval BatchNorm; "
                             "call .eval() first, or use route='autograd'")
        conv3x3.refuse_grad(f"{type(self).__name__} route={route!r}", x,
                            *self.parameters())

    def _folded(self, name: str, conv: nn.Conv2d,
                bn: Optional[nn.BatchNorm2d], dtype: torch.dtype):
        """(HWIO weight in ``dtype``, f32 bias, the weight's
        ``tf32_weights`` copy in f32 else None) of ``conv`` with ``bn``
        folded in; a conv without bias and BatchNorm gets a zero bias."""
        ts = [conv.weight] + ([] if conv.bias is None else [conv.bias])
        if bn is not None:
            ts += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
        stamp = tuple((t.data_ptr(), t._version) for t in ts)
        hit = self._kparams.get((name, dtype))
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                if bn is None:
                    w = conv.weight.detach().float()
                    b = (torch.zeros(w.shape[0], device=w.device)
                         if conv.bias is None else conv.bias.detach().float())
                else:
                    w, b = fold_batch_norm(conv.weight.detach(),
                                           None if conv.bias is None
                                           else conv.bias.detach(), bn)
                hwio = w.permute(2, 3, 1, 0).to(dtype).contiguous()
                split = (conv3x3.tf32_weights(hwio)
                         if dtype == torch.float32 else None)
            hit = (stamp, hwio, b.contiguous(), split)
            self._kparams[(name, dtype)] = hit
        return hit[1:]

    def _conv(self, name: str, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d],
              x: torch.Tensor, relu: bool, route: str) -> torch.Tensor:
        """One 3×3 conv (+ folded BN, + ReLU if asked) on NHWC ``x``: K2, or
        its plain version."""
        w, b, split = self._folded(name, conv, bn, x.dtype)
        if route == "plain":
            return conv3x3.conv3x3_bias_relu_plain(x, w, b, relu=relu)
        return conv3x3.conv3x3_bias_relu(x, w, b, relu=relu,
                                         kernel_tf32=split)

    def _pair(self, first: tuple, second: tuple, x: torch.Tensor,
              route: str) -> torch.Tensor:
        """Two 3×3 conv(+ folded BN)+ReLU layers on NHWC ``x``: K3, or its
        plain version; ``first`` and ``second`` are (name, conv, bn)."""
        w1, b1, s1 = self._folded(*first, x.dtype)
        w2, b2, s2 = self._folded(*second, x.dtype)
        if route == "plain":
            return double_conv.double_conv3x3_relu_plain(x, w1, b1, w2, b2)
        return double_conv.double_conv3x3_relu(x, w1, b1, w2, b2, w1_tf32=s1,
                                               w2_tf32=s2)
