"""The yardstick's arithmetic: published peaks of one NVIDIA H100 and the
operations and bytes of each conv the benchmarked programs run, counted from
shapes.

Peaks are NVIDIA's data sheet for the SXM part, dense, at its 700 W limit.
A kernel's bound is the larger of its operations at the peak of the
precision it computes in and its bytes at the HBM bandwidth, each input byte
read once and each output byte written once (the formulas of the port's
``chip_smoke.py``, copied: ``phase_int8_times`` for K2's s8 mode, K5 and
K6, ``family_f32_times`` for K3 and K2 in float32).

The float32 bodies of K2 and K3 are held against the published TF32 peak:
the fastest rate the card computes float32 inputs at, so that no float32
body, however it computes, can read above 100%.  The port's body runs three
TF32 products per product, so its own ceiling is a third of that.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12  # dense int8 (and fp8)
PEAK_BF16_FLOPS = 989e12  # dense bf16
PEAK_TF32_FLOPS = 495e12  # dense TF32
PEAK_BYTES = 3.35e12  # HBM3

# The U-Net's convs at an input of N x H x W (``DenoiseGenerator``): per
# conv, (name, resolution divisor, input channels, output channels, kind),
# kind "conv3" a 3x3 stride-1 conv, "convt2" a 2x2 stride-2 transpose conv
# whose resolution is its input's.  Convs 7 and 10 read the concat of the
# upsampled half and the skip.
UNET_CONVS = (
    ("down1.0", 1, 3, 64, "conv3"), ("down1.2", 1, 64, 64, "conv3"),
    ("down2.0", 2, 64, 128, "conv3"), ("down2.2", 2, 128, 128, "conv3"),
    ("bottleneck.0", 4, 128, 256, "conv3"),
    ("bottleneck.2", 4, 256, 256, "conv3"),
    ("up2", 4, 256, 128, "convt2"),
    ("upconv2.0", 2, 256, 128, "conv3"), ("upconv2.2", 2, 128, 128, "conv3"),
    ("up1", 2, 128, 64, "convt2"),
    ("upconv1.0", 1, 128, 64, "conv3"), ("upconv1.2", 1, 64, 3, "conv3"),
)
# the s8 program's kernel per U-Net conv (``ops/quant_unet.py``): conv 0 on
# K2's s8-out mode, the transpose convs on K6, every other conv on K5 (the
# output conv with a bf16 output)
UNET_INT8_KERNEL = {"down1.0": "K2", "up2": "K6", "up1": "K6"}


def conv_ops(n: int, h: int, w: int, cin: int, cout: int, kind: str) -> int:
    """Multiply-adds x 2 of one conv at an input of n x h x w."""
    taps = 9 if kind == "conv3" else 4
    return 2 * n * h * w * taps * cin * cout


def unet_flops(n: int, h: int, w: int) -> int:
    """The U-Net's convolution operations for n images of h x w (about
    184 GFLOP for one 512 x 512 image)."""
    return sum(conv_ops(n, h // d, w // d, cin, cout, kind)
               for _, d, cin, cout, kind in UNET_CONVS)


def int8_unet_launches(n: int, h: int, w: int) -> list:
    """One forward of the s8 program at n x h x w: per launch of K2 (s8
    out), K5 or K6, (kernel, conv name, operations, bytes, bound seconds).
    K2's s8 mode multiplies in bf16; K5 and K6 in int8."""
    out = []
    for name, d, cin, cout, kind in UNET_CONVS:
        hh, ww = h // d, w // d
        ops = conv_ops(n, hh, ww, cin, cout, kind)
        k = UNET_INT8_KERNEL.get(name, "K5")
        pix = n * hh * ww
        if k == "K2":  # bf16 in, s8 out, bf16 weights
            nbytes = 2 * pix * cin + pix * cout + 2 * 9 * cin * cout
            peak = PEAK_BF16_FLOPS
        elif k == "K6":  # s8 in, s8 out at 4x the pixels, s8 weights
            nbytes = pix * cin + 4 * cin * cout + 4 * pix * cout
            peak = PEAK_INT8_OPS
        else:  # s8 in; s8 out, the output conv bf16 out
            out_bytes = 2 if name == "upconv1.2" else 1
            nbytes = pix * cin + 9 * cin * cout + pix * cout * out_bytes
            peak = PEAK_INT8_OPS
        out.append((k, name, ops, nbytes, bound_s(ops, nbytes, peak)))
    return out


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time: operations at ``peak_ops`` or bytes at HBM speed."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


# DnCNN (Zhang et al. 2017) at depth 17, 64 features: conv 0 (3 -> 64),
# 15 conv+BN (64 -> 64), the last conv (64 -> 3)
def dncnn_convs(depth: int = 17, features: int = 64, channels: int = 3):
    return ([(channels, features)] + [(features, features)] * (depth - 2)
            + [(features, channels)])


def dncnn_flops(n: int, h: int, w: int, depth: int = 17,
                features: int = 64) -> int:
    """DnCNN's convolution operations for n images of h x w (about 1.11
    MFLOP a pixel at depth 17)."""
    return sum(conv_ops(n, h, w, cin, cout, "conv3")
               for cin, cout in dncnn_convs(depth, features))


def f32_pair_launch(n: int, h: int, w: int, c0: int, c1: int, c2: int):
    """K3 in float32 (two 3x3 conv+ReLU layers in one launch): (operations,
    bytes, bound seconds at the TF32 peak)."""
    ops = 2 * n * h * w * 9 * (c0 * c1 + c1 * c2)
    nbytes = 4 * (n * h * w * c0 + 9 * c0 * c1 + 9 * c1 * c2 + c1 + c2
                  + n * h * w * c2)
    return ops, nbytes, bound_s(ops, nbytes, PEAK_TF32_FLOPS)


def dncnn_k3_launches(n: int, h: int, w: int, depth: int = 17,
                      features: int = 64) -> list:
    """One forward of DnCNN's kernel route (``models/folded.py``): its
    conv+ReLU layers in pairs on K3, (operations, bytes, bound seconds)
    per K3 launch."""
    relu_convs = dncnn_convs(depth, features)[:-1]
    return [f32_pair_launch(n, h, w, relu_convs[i][0], relu_convs[i][1],
                            relu_convs[i + 1][1])
            for i in range(0, len(relu_convs) - 1, 2)]
