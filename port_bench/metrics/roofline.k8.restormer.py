"""K8 (the depthwise 3x3 conv, float32, GDFN's gate fused) against its
roofline: per launch its operations at 67 TFLOP/s or its bytes (input,
output and weights once each) at 3.35 TB/s, summed over the launches of
the window's completed requests, over the device seconds of the trace's
records of ``dwconv3x3_f32_kernel`` (both instances: with and without the
gate)."""

from port_bench import roofline_restormer as rr


def read(ctx):
    return rr.kernel_share(ctx, rr.K8_NAME, rr.k8_launches)
