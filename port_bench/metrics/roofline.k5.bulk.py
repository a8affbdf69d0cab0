"""K5 (the int8 3x3 conv) against its roofline: the bound of each launch
(operations at 1979 TOP/s or bytes at 3.35 TB/s, each byte counted once),
summed over the window's launches, over the device time of its records."""

from port_bench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "K5",
                                   readers.unet_int8_bounds(ctx, "K5"))
