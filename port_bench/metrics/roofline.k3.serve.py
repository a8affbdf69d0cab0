"""K3 (two 3x3 conv+ReLU layers in one launch, float32) against its
roofline: operations at the published TF32 peak (495 TFLOP/s) or bytes at
3.35 TB/s, summed over the window's launches, over its records' device
time."""

from port_bench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "K3", readers.dncnn_k3_bounds(ctx))
