"""The served f32 DnCNN's share of the card's peak while the card works:
DnCNN's convolution operations per image (counted from shapes, about 1.11
MFLOP a pixel) times the requests completed in the traced window, over the
seconds in which a kernel or a copy ran on the card, over 495 TFLOP/s, the
published TF32 peak: the fastest rate for float32 inputs, so no float32
body can read above 100% whatever it computes with.

Over busy seconds, not the window: requests arrive at a fixed rate, so the
operations over the window's length would restate the arrival rate and no
change to the model or its kernels could move it."""

from port_bench import readers, roofline


def read(ctx):
    size, cfg = ctx["traffic"]["size"], ctx["config"]
    return readers.step_share(
        ctx, roofline.dncnn_flops(1, size, size, cfg["depth"],
                                  cfg["features"]),
        roofline.PEAK_TF32_FLOPS, over="busy_s")
