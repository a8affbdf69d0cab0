"""The served f32 Restormer's share of the card's peak while the card
works: Restormer's operations per request by the published equations
(counted from shapes, about 4.94 TFLOP at 1024 x 1024:
``roofline_restormer.forward_flops``) times the requests completed in the
traced window, over the seconds in which a kernel or a copy ran on the
card, over 495 TFLOP/s, the published TF32 peak (the fastest rate for
float32 inputs), as ``mfu.serve`` holds DnCNN."""

from port_bench import readers, roofline, roofline_restormer


def read(ctx):
    size = ctx["traffic"]["size"]
    return readers.step_share(
        ctx, roofline_restormer.forward_flops(ctx["config"]["arch"], size,
                                              size),
        roofline.PEAK_TF32_FLOPS, over="busy_s")
