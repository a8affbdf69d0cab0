"""The served int8 U-Net step's share of the card's int8 peak: the U-Net's
convolution operations per image (counted from shapes) times the images
completed in the traced window, over its length, over 1979 TOP/s, the
fastest of the precisions the step computes in (bf16 conv 0, int8 rest)."""

from port_bench import readers, roofline


def read(ctx):
    size = ctx["traffic"]["size"]
    return readers.step_share(ctx, roofline.unet_flops(1, size, size),
                              roofline.PEAK_INT8_OPS)
