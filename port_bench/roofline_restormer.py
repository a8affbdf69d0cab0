"""Restormer's operations and bytes, counted from the configuration's
shapes at an input of H x W (the ``restormer`` configuration's ``arch``):
the whole forward's operations by the published equations, and each launch
of the port's two Restormer kernels with its bound.

Operations are multiply-adds x 2 of the convs and matmuls (the 3x3, 1x1
and depthwise convs, MDTA's q k^T and A v); LayerNorm, the softmax, the
gate and the residual adds are left out (elementwise, a few per value).
About 2.36 M multiply-adds a pixel at the published widths: 4.94 TFLOP at
1024 x 1024.

K7 (``mdta_attention_kernel``): per block, the Gram matrix of each head
over the pixels and the 2C sums of squares, on the CUDA cores in float32;
it reads q and k once (8 C bytes a pixel) and writes each head's d x d
matrix.  K8 (``dwconv3x3_f32_kernel``): per block, MDTA's depthwise conv
(3C channels in and out) and GDFN's with its gate (2 hidden in, hidden
out), 9 multiply-adds per input value, each byte in and out counted once.
Both compute in float32 on the CUDA cores: their operations are held
against the card's float32 peak outside the tensor cores, their bytes
against HBM's.
"""

from __future__ import annotations

from port_bench.roofline import bound_s

PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def levels(arch: dict) -> list:
    """(name, channels, heads, blocks, resolution divisor) of every level
    of blocks, in the forward's order."""
    d, nb, hs = arch["dim"], arch["num_blocks"], arch["heads"]
    return [("encoder_level1", d, hs[0], nb[0], 1),
            ("encoder_level2", 2 * d, hs[1], nb[1], 2),
            ("encoder_level3", 4 * d, hs[2], nb[2], 4),
            ("latent", 8 * d, hs[3], nb[3], 8),
            ("decoder_level3", 4 * d, hs[2], nb[2], 4),
            ("decoder_level2", 2 * d, hs[1], nb[1], 2),
            ("decoder_level1", 2 * d, hs[0], nb[0], 1),
            ("refinement", 2 * d, hs[0], arch["num_refinement_blocks"], 1)]


def hidden(arch: dict, c: int) -> int:
    return int(c * arch["ffn_expansion_factor"])


def block_flops(arch: dict, hw: int, c: int, heads: int) -> int:
    """One transformer block's operations over hw pixels."""
    hid = hidden(arch, c)
    d = c // heads
    mdta = (c * 3 * c + 9 * 3 * c + 2 * c * d + c * c) * hw
    gdfn = (c * 2 * hid + 9 * 2 * hid + hid * c) * hw
    return 2 * (mdta + gdfn)


def forward_flops(arch: dict, h: int, w: int) -> int:
    """Restormer's operations for one H x W image (H, W multiples of 8)."""
    d = arch["dim"]
    px = h * w
    ops = 2 * px * 9 * arch["inp_channels"] * d  # patch embed
    for _, c, heads, n, div in levels(arch):
        ops += n * block_flops(arch, px // div ** 2, c, heads)
    for c, div in ((d, 1), (2 * d, 2), (4 * d, 4)):  # down: C -> C/2
        ops += 2 * (px // div ** 2) * 9 * c * (c // 2)
    for c, div in ((8 * d, 8), (4 * d, 4), (2 * d, 2)):  # up: C -> 2C
        ops += 2 * (px // div ** 2) * 9 * c * 2 * c
    ops += 2 * (px // 16) * 8 * d * 4 * d  # reduce_chan_level3
    ops += 2 * (px // 4) * 4 * d * 2 * d  # reduce_chan_level2
    ops += 2 * px * 9 * 2 * d * arch["out_channels"]  # output conv
    return ops


def k7_launches(arch: dict, h: int, w: int) -> list:
    """One forward's K7 launches: (operations, bytes, bound seconds)."""
    out = []
    for _, c, heads, n, div in levels(arch):
        hw = h * w // div ** 2
        d = c // heads
        ops = 2 * hw * (c * d + 2 * c)
        nbytes = 4 * (2 * c * hw + heads * d * d + heads)
        out += [(ops, nbytes, bound_s(ops, nbytes, PEAK_F32_FLOPS))] * n
    return out


def k8_launches(arch: dict, h: int, w: int) -> list:
    """One forward's K8 launches (MDTA's, then GDFN's, a block):
    (operations, bytes, bound seconds)."""
    out = []
    for _, c, _, n, div in levels(arch):
        hw = h * w // div ** 2
        hid = hidden(arch, c)
        for cin, cout in ((3 * c, 3 * c), (2 * hid, hid)):
            ops = 2 * hw * 9 * cin
            nbytes = 4 * (hw * (cin + cout) + 9 * cin)
            launch = (ops, nbytes, bound_s(ops, nbytes, PEAK_F32_FLOPS))
            out += [launch] * n
    return out


# the device functions of the port's Restormer kernels, as their records
# in a trace name them
K7_NAME = "mdta_attention_kernel"
K8_NAME = "dwconv3x3_f32_kernel"
MIN_REQUESTS = 30


def device_seconds(ctx, name: str):
    """The device seconds of every entry of the traced window's top device
    ops whose name holds ``name`` (None where none does)."""
    hits = [s for op, s in ctx["trace"]["breakdown"]["device_ops"]
            if name in op]
    return sum(hits) if hits else None


def kernel_share(ctx, name: str, launches) -> float:
    """Percent: the bound seconds of one forward's launches of the kernel
    (``launches(arch, h, w)``) times the requests completed in the traced
    window, over the device seconds of the kernel's records; None where
    fewer than ``MIN_REQUESTS`` completed or no record is named."""
    requests = ctx["work"].get("requests", 0)
    seconds = device_seconds(ctx, name)
    if requests < MIN_REQUESTS or not seconds:
        return None
    size = ctx["traffic"]["size"]
    bound = sum(b for *_, b in launches(ctx["config"]["arch"], size, size))
    return 100.0 * requests * bound / seconds
