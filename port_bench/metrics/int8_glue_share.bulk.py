"""Percent of the traced window's kernel time spent outside K2, K5 and K6:
the int8 program's glue (the s8 max-pools, the tanh, the casts) and the
server's output map to uint8."""


def read(ctx):
    t = ctx["trace"]
    total = t["kernel_total_s"]
    if not total:
        return None
    mine = sum(t["kernel_s"][k] for k in ("K2", "K5", "K6"))
    return 100.0 * (total - mine) / total
