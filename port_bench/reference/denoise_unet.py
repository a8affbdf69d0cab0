"""Plain reference of the ``denoise_unet`` configuration as it is served:
the U-Net's s8 skip-storage int8 program, worked out again from the shipped
weights and from the published recipe, in plain PyTorch.

The U-Net (``DenoiseGenerator`` of flawyer/Celebrity-Image-Denoiser
``backend/app.py:39``): (3->64->64) pool (64->128->128) pool
(128->256->256), 2x2 stride-2 transpose-conv ups with the decoder half
first in each concat, ReLU, tanh.  The served int8 program:

* calibration: one float32 forward (TF32 off) over the calibration batch
  (8 synthetic images at 128 x 128 plus 0.12 N(0, 1), clipped, in [-1, 1],
  drawn on the CPU from a generator seeded 0); per conv, each input
  channel's max |x|;
* activation scales: max(amax_c, 0.01 max amax) / Q; weights folded with
  the scale of their input channel and quantized per output channel at
  amax / Q, rounding half to even, clipped to +-Q (Q = 127 for int8);
* conv 0 multiplies bf16 inputs by bf16 weights, rounds to bf16, adds the
  bf16 bias, ReLU, then quantizes; every later conv sums integers exactly,
  scales in float32, rounds to bf16, adds the bf16 bias, ReLU, quantizes at
  the scale its consumer reads (skips, pool inputs and both concat halves
  stay integers); max-pool on the integers; the output conv keeps bf16 and
  takes tanh;
* served pixels: clip(y / 2 + 1 / 2, 0, 1) x 255, truncated to uint8.

``precision="int4"`` is the control: the same program with Q = 7.  Integer
sums are computed in float64, which is exact for every sum here.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import gen

# conv names in call order; the transpose convs
PATHS = ("down1.0", "down1.2", "down2.0", "down2.2", "bottleneck.0",
         "bottleneck.2", "up2", "upconv2.0", "upconv2.2", "up1", "upconv1.0",
         "upconv1.2")
TRANSPOSED = (6, 9)
LEVELS = {"int8": 127, "int4": 7}


def load_weights(weights_dir: str, device) -> dict:
    """name -> (weight in PyTorch's layout, bias), float32 on ``device``:
    HWIO kernels to OIHW, (kH, kW, Cout, Cin) transpose kernels to
    (Cin, Cout, kH, kW)."""
    with np.load(os.path.join(weights_dir, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    out = {}
    for name in PATHS:
        k = flat[f"generator.{name}.kernel"].transpose(3, 2, 0, 1)
        out[name] = (torch.tensor(np.ascontiguousarray(k), device=device),
                     torch.tensor(flat[f"generator.{name}.bias"],
                                  device=device))
    return out


def calibration_batch(c: dict) -> torch.Tensor:
    """The served program's calibration batch, as the configuration states
    it (``calibration``: 8 images of 128 x 128, sigma 0.12, a generator
    seeded 0), in [-1, 1], drawn on the CPU."""
    g = torch.Generator().manual_seed(c["generator_seed"])
    clean = gen.clean_batch(g, c["images"], c["size"])
    noise = torch.randn(clean.shape, generator=g)
    return torch.clamp(clean + c["sigma"] * noise, 0.0, 1.0) * 2.0 - 1.0


def float_forward(w: dict, x: torch.Tensor, taps=None) -> torch.Tensor:
    """The U-Net in float32 on NCHW ``x``; appends each conv's input to
    ``taps`` when given."""
    def conv(name, h):
        if taps is not None:
            taps.append(h)
        weight, bias = w[name]
        if name in ("up2", "up1"):
            return F.conv_transpose2d(h, weight, bias, stride=2)
        # the bias added after the conv, as the published layers add it
        return F.conv2d(h, weight, padding=1) + bias.view(1, -1, 1, 1)

    e1 = F.relu(conv("down1.2", F.relu(conv("down1.0", x))))
    e2 = F.relu(conv("down2.2", F.relu(conv("down2.0", F.max_pool2d(e1, 2)))))
    b = F.relu(conv("bottleneck.2", F.relu(conv("bottleneck.0",
                                                F.max_pool2d(e2, 2)))))
    d2 = conv("up2", b)
    e2 = e2[:, :, :d2.shape[2], :d2.shape[3]]
    d2 = F.relu(conv("upconv2.2", F.relu(conv("upconv2.0",
                                              torch.cat([d2, e2], 1)))))
    d1 = conv("up1", d2)
    e1 = e1[:, :, :d1.shape[2], :d1.shape[3]]
    d1 = conv("upconv1.2", F.relu(conv("upconv1.0", torch.cat([d1, e1], 1))))
    return torch.tanh(d1)


def _quantize(v: torch.Tensor, scale: torch.Tensor, q: int) -> torch.Tensor:
    return torch.clamp(torch.round(v.float() / scale), -q, q)


def _conv3_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer 3x3 'same' conv: x (N, H, W, Cin), w (Cout, Cin, 3, 3),
    both integer-valued; float64 sums."""
    _, h, wd, _ = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    wt = w.double()
    y = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + wd] @ wt[:, :, dy, dx].T
            y = t if y is None else y + t
    return y


def _convt2_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer 2x2 stride-2 transpose conv: x (N, H, W, Cin), w
    (Cin, Cout, 2, 2)."""
    n, h, wd, _ = x.shape
    y = torch.einsum("nhwc,cdab->nhawbd", x.double(), w.double())
    return y.reshape(n, 2 * h, 2 * wd, w.shape[1])


class Reference:
    """``ref(u8)``: uint8 NHWC noisy images -> the served uint8 output."""

    def __init__(self, config: dict, device, precision: str = None):
        self.device = torch.device(device)
        self.precision = precision or config["precision"]
        q = LEVELS[self.precision]
        self.q = q
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        w = load_weights(config["weights"], self.device)
        taps = []
        with torch.no_grad():
            float_forward(w, calibration_batch(config["calibration"]).to(
                self.device).permute(0, 3, 1, 2), taps)
        amax = [t.abs().amax(dim=(0, 2, 3)) for t in taps]
        s = [torch.clamp_min(torch.maximum(a, 0.01 * a.max()), 1e-12) / q
             for a in amax]
        # the scale each conv's input is folded with, and the scale its
        # output is stored at (what its consumer reads)
        fold = {1: s[1], 2: s[10][64:], 3: s[3], 4: s[7][128:], 5: s[5],
                6: s[6], 7: s[7], 8: s[8], 9: s[9], 10: s[10], 11: s[11]}
        self.out_scale = {0: s[1], 1: s[10][64:], 2: s[3], 3: s[7][128:],
                          4: s[5], 5: s[6], 6: s[7][:128], 7: s[8], 8: s[9],
                          9: s[10][:64], 10: s[11]}
        self.wq, self.ws = {}, {}
        for i in range(1, 12):
            weight = w[PATHS[i]][0]
            in_axis, out_axis = (0, 1) if i in TRANSPOSED else (1, 0)
            shape = [1, 1, 1, 1]
            shape[in_axis] = -1
            folded = weight * fold[i].view(shape)
            dims = tuple(d for d in range(4) if d != out_axis)
            scale = torch.clamp_min(folded.abs().amax(dim=dims), 1e-12) / q
            sshape = [1, 1, 1, 1]
            sshape[out_axis] = -1
            self.wq[i] = torch.clamp(torch.round(folded / scale.view(sshape)),
                                     -q, q)
            self.ws[i] = scale
        self.bias = {i: w[PATHS[i]][1].to(torch.bfloat16) for i in range(12)}
        self.w0 = w[PATHS[0]][0].to(torch.bfloat16)

    def _epilogue(self, acc, i, relu=True, out=True):
        h = (acc.float() * self.ws[i]).to(torch.bfloat16) + self.bias[i]
        if relu:
            h = torch.relu(h)
        return _quantize(h, self.out_scale[i], self.q) if out else h

    def _conv(self, i, h, relu=True, out=True):
        return self._epilogue(_conv3_exact(h, self.wq[i]), i, relu, out)

    def _up(self, i, h):
        return self._epilogue(_convt2_exact(h, self.wq[i]), i, relu=False)

    @staticmethod
    def _pool(h):
        n, hh, ww, c = h.shape
        return h[:, :hh // 2 * 2, :ww // 2 * 2].reshape(
            n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float32 in [-1, 1] -> NHWC float32 tanh output."""
        xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        y0 = F.conv2d(xb, self.w0.float(), padding=1)
        h = y0.to(torch.bfloat16).permute(0, 2, 3, 1) + self.bias[0]
        h = _quantize(torch.relu(h), self.out_scale[0], self.q)
        e1 = self._conv(1, h)
        e2 = self._conv(3, self._conv(2, self._pool(e1)))
        bo = self._conv(5, self._conv(4, self._pool(e2)))
        d2a = self._up(6, bo)
        e2 = e2[:, :d2a.shape[1], :d2a.shape[2]]
        d2 = self._conv(8, self._conv(7, torch.cat([d2a, e2], 3)))
        d1a = self._up(9, d2)
        e1 = e1[:, :d1a.shape[1], :d1a.shape[2]]
        y = self._conv(11, self._conv(10, torch.cat([d1a, e1], 3)),
                       relu=False, out=False)
        return torch.tanh(y).float()

    def __call__(self, u8: torch.Tensor) -> torch.Tensor:
        x = gen.served_domain(u8.to(self.device), "[-1,1]")
        y = self.forward(x)
        return (torch.clamp(y * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)
