"""Milliseconds of host-to-device and device-to-host copies on the device
per request completed in the traced window."""


def read(ctx):
    t, work = ctx["trace"], ctx["work"]
    if not work.get("requests"):
        return None
    seconds = t["copy_s"]["HtoD"] + t["copy_s"]["DtoH"]
    if not seconds:
        return None
    return 1e3 * seconds / work["requests"]
