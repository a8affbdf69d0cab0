"""K9 (Restormer's 1×1 convs as float32 GEMMs over the pixel rows, three
TF32 products a multiply on the tensor cores, the LayerNorm before qkv and
project_in folded in as a row scale) against its roofline: per launch its
operations at 495 TFLOP/s, the published TF32 peak (so that no float32
GEMM, however it computes, reads above 100%), or its bytes at 3.35 TB/s,
summed over the launches of the window's completed requests, over the
device seconds of the trace's records of ``pointwise_gemm``.

A forward's launches (``k9_launches``): per block qkv (C → 3C), MDTA's
``v · W_effᵀ + x`` (C → C, a weight per image, the residual), project_in
(C → 2·hidden) and project_out (hidden → C, the residual); and the two
channel reductions of decoder levels 3 and 2.  Per launch the operations
are 2·M·K·N and the bytes 4·(M·K + M·N, + M·N where a residual is read, +
the weights' N·K): each operand and the output once.  178 launches, 3.95
TFLOP, 109 GB and a bound of 32.6 ms at 1024 × 1024."""

from port_bench import roofline
from port_bench import roofline_restormer as rr

K9_NAME = "pointwise_gemm"


def _launch(m: int, k: int, n: int, residual: bool) -> tuple:
    ops = 2 * m * k * n
    nbytes = 4 * (m * k + m * n + (m * n if residual else 0) + n * k)
    return ops, nbytes, roofline.bound_s(ops, nbytes,
                                         roofline.PEAK_TF32_FLOPS)


def k9_launches(arch: dict, h: int, w: int) -> list:
    """One forward's K9 launches: (operations, bytes, bound seconds)."""
    out = []
    for _, c, _, n, div in rr.levels(arch):
        m = h * w // div ** 2
        hid = rr.hidden(arch, c)
        out += [_launch(m, c, 3 * c, False), _launch(m, c, c, True),
                _launch(m, c, 2 * hid, False),
                _launch(m, hid, c, True)] * n
    d = arch["dim"]
    out += [_launch(h * w // 16, 8 * d, 4 * d, False),  # reduce_chan_level3
            _launch(h * w // 4, 4 * d, 2 * d, False)]  # reduce_chan_level2
    return out


def read(ctx):
    return rr.kernel_share(ctx, K9_NAME, k9_launches)
