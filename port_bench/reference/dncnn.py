"""Plain reference of the ``dncnn`` configuration as it is served: DnCNN
(Zhang et al., IEEE TIP 2017, arXiv:1608.03981) in float32 from the shipped
weights, in plain PyTorch with TF32 off.

Conv(3->64)+ReLU, (depth - 2) x (Conv(64->64, no bias) + BatchNorm in eval
mode + ReLU), Conv(64->3, no bias); the network predicts the noise, and the
output is x - residual, in [0, 1].  The BatchNorm runs as published, after
its conv (at the configuration's eps), not folded into it.  Served pixels:
clip(y, 0, 1) x 255, truncated to uint8.  (The server's host then divides
by 255 in float32, multiplies by 255 and truncates again; for every uint8
value that returns the value itself, so it is left out here.)

``precision="tf32"`` is the control: the same network with every conv's
operands rounded to TF32 (10 mantissa bits), by cuDNN's TF32 mode on the
card and by rounding the operands on the CPU.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F


def load_weights(weights_dir: str, device, depth: int) -> list:
    """Per conv, (OIHW weight, bias or None, BatchNorm (scale, bias, mean,
    var) or None), float32 on ``device``."""
    with np.load(os.path.join(weights_dir, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}

    def t(key):
        return torch.tensor(np.ascontiguousarray(flat[key]), device=device)

    layers = []
    idx = 0  # the module index of each conv in the published Sequential
    for i in range(depth):
        w = t(f"generator.body.{idx}.kernel").permute(3, 2, 0, 1).contiguous()
        b = t(f"generator.body.{idx}.bias") if i == 0 else None
        bn = None
        if 0 < i < depth - 1:
            j = idx + 1
            bn = (t(f"generator.body.{j}.scale"),
                  t(f"generator.body.{j}.bias"),
                  t(f"generator_state.body.{j}.mean"),
                  t(f"generator_state.body.{j}.var"))
        layers.append((w, b, bn))
        idx += 2 if i == 0 else 3
    return layers


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest, ties away."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Reference:
    """``ref(u8)``: uint8 NHWC noisy images -> the served uint8 output."""

    def __init__(self, config: dict, device, precision: str = None):
        self.device = torch.device(device)
        self.precision = precision or config["precision"]
        if self.precision not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {self.precision!r}")
        self.layers = load_weights(config["weights"], self.device,
                                   config["depth"])
        self.eps = config["batchnorm_eps"]

    def _tf32_scope(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return _cudnn_tf32(self.precision == "tf32")

    def _conv(self, h, w, b):
        if self.precision == "tf32" and self.device.type != "cuda":
            h, w = _round_tf32(h), _round_tf32(w)
        return F.conv2d(h, w, b, padding=1)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW float32 in [0, 1] -> NCHW float32 output."""
        h = x
        last = len(self.layers) - 1
        with self._tf32_scope():
            for i, (w, b, bn) in enumerate(self.layers):
                h = self._conv(h, w, b)
                if bn is not None:
                    scale, bias, mean, var = bn
                    h = F.batch_norm(h, mean, var, scale, bias,
                                     training=False, eps=self.eps)
                if i < last:
                    h = torch.relu(h)
        return x - h

    def __call__(self, u8: torch.Tensor) -> torch.Tensor:
        x = (u8.to(self.device).float() / 255.0).permute(0, 3, 1, 2)
        y = self.forward(x).permute(0, 2, 3, 1)
        return (torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8)


@contextlib.contextmanager
def _cudnn_tf32(on: bool):
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old
