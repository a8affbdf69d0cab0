"""K7 (MDTA's core: each head's Gram matrix over the pixels, the norms,
the temperature and the softmax, float32 on the CUDA cores) against its
roofline: per launch its operations at 67 TFLOP/s or its bytes (q and k
read once, the attention written once) at 3.35 TB/s, summed over the
launches of the window's completed requests, over the device seconds of
the trace's records of ``mdta_attention_kernel``."""

from port_bench import roofline_restormer as rr


def read(ctx):
    return rr.kernel_share(ctx, rr.K7_NAME, rr.k7_launches)
