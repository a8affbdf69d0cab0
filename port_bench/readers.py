"""What the per-layer metrics' readers share: each reads the traced
window's summary (``trace.summarize``) and the work done in it, and returns
None where the trace has nothing to read."""

from __future__ import annotations

from port_bench import roofline


def idle_share(ctx):
    """Percent of the traced window in which no kernel or copy ran on the
    device."""
    t = ctx["trace"]
    if not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def step_share(ctx, flops_per_image: float, peak: float,
               over: str = "window_s"):
    """Percent of ``peak`` that the whole served step reaches: the model's
    operations for every image completed in the traced window over the
    window's length (``over="window_s"``), or over the seconds in which the
    card was busy in it (``"busy_s"``)."""
    t, work = ctx["trace"], ctx["work"]
    if not work["images"] or not t[over]:
        return None
    return 100.0 * flops_per_image * work["images"] / t[over] / peak


def kernel_roofline(ctx, kernel: str, per_forward: list):
    """Percent: the bound seconds of ``kernel``'s launches in the window
    (``per_forward``: the bound of each of its launches in one forward)
    over the device seconds its records took."""
    t = ctx["trace"]
    seconds = t["kernel_s"].get(kernel, 0.0)
    launches = t["launches"].get(kernel, 0)
    if not seconds or not launches or launches % len(per_forward):
        return None
    forwards = launches // len(per_forward)
    return 100.0 * forwards * sum(per_forward) / seconds


def unet_int8_bounds(ctx, kernel: str) -> list:
    tr = ctx["traffic"]
    return [b for k, _, _, _, b in roofline.int8_unet_launches(
        tr["batch"], tr["size"], tr["size"]) if k == kernel]


def dncnn_k3_bounds(ctx) -> list:
    tr, cfg = ctx["traffic"], ctx["config"]
    return [b for _, _, b in roofline.dncnn_k3_launches(
        1, tr["size"], tr["size"], cfg["depth"], cfg["features"])]
