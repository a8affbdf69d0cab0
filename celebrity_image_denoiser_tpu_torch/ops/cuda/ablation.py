"""Where the conv kernels' time goes: the kernels timed with parts taken out.

    python3 -m celebrity_image_denoiser_tpu_torch.ops.cuda.ablation
        [--only bf16|s8|f32|narrow]

Builds variants of the conv sources in which one or more parts are patched
out of the source text (the matrix instructions, the ldmatrix loads, the
copies, the epilogues or only their arithmetic), and times each variant on
the card: ``bf16``, the bf16 kernels (``csrc/conv3x3_bias_relu.cu``,
``csrc/double_conv3x3_relu.cu``) at the bench shapes (128², batch 256) and
K2's s8-out mode at the int8 step's first conv (``down1.0 q8``); ``s8``,
the int8 kernels K5 (``csrc/conv3x3_s8.cu``) and K6
(``csrc/convt2x2_s8.cu``) at the int8 step's layers.  A variant's results are wrong;
only its time is read: what a part costs is the time that goes away with
it, and what is left when everything is out is the ring's skeleton (barriers
and bookkeeping).  Where ncu and nsys cannot run, this takes the place of
a kernel profile.  ``f32``: the f32 bodies of K2 and K3 (three TF32
products) beside the design's alternatives, which compute the right
function: K3's items of one tap row where all 9 taps fit, its 16x16 tile
at C1p = 128, and one wgmma accumulator taking every product instead of a
partial sum a chunk; each launch's error against the plain version is
printed too (batch 1, the f32 rows' 512x512 input).  With it, ``f32
narrow`` (or ``--only narrow`` alone): K2's f32 body for Cout <= 4 at its
three rows (``upconv1.2``, dncnn's ``body.47``, the cGAN's tail at 2048²)
as built, with runs of 8 pixels and four stages, runs of 4 pixels, chunks
of 32 or 16 channels, and with its copies, its FMAs (and their
shared-memory loads) or its epilogue (the shuffles and the stores) patched
out; timed on the device's clock (``ops/cuda/timing.py``).  Needs one CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build, timing

BATCH = 256
# layer: (N, H, W, C0, C1, C2) for the double conv, (N, H, W, Cin, Cout,
# relu) for the single conv
K3 = {"down1": (BATCH, 128, 128, 3, 64, 64),
      "down2": (BATCH, 64, 64, 64, 128, 128),
      "bottleneck": (BATCH, 32, 32, 128, 256, 256),
      "upconv2": (BATCH, 64, 64, 256, 128, 128)}
K2 = {"upconv1.0": (BATCH, 128, 128, 128, 64, 1)}
Q8 = {"down1.0 q8": (BATCH, 128, 128, 3, 64, 1)}  # K2, s8 out
# the int8 step's K5 convs, (N, H, W, Ca, Cb, Cout, relu, mode) with mode 0
# s8 out, 1 bf16 out (chip_smoke.py's int8_layers), and its K6 transpose
# convs, (N, H, W, Cin, Cout), s8 out
K5 = {"down1.2": (BATCH, 128, 128, 64, 0, 64, 1, 0),
      "down2.0": (BATCH, 64, 64, 64, 0, 128, 1, 0),
      "down2.2": (BATCH, 64, 64, 128, 0, 128, 1, 0),
      "bottleneck.0": (BATCH, 32, 32, 128, 0, 256, 1, 0),
      "bottleneck.2": (BATCH, 32, 32, 256, 0, 256, 1, 0),
      "upconv2.0": (BATCH, 64, 64, 128, 128, 128, 1, 0),
      "upconv2.2": (BATCH, 64, 64, 128, 0, 128, 1, 0),
      "upconv1.0": (BATCH, 128, 128, 64, 64, 64, 1, 0),
      "upconv1.2": (BATCH, 128, 128, 64, 0, 3, 0, 1)}
K6 = {"up2": (BATCH, 32, 32, 256, 128), "up1": (BATCH, 64, 64, 128, 64)}

# part -> [(file, text, replacement)]; every text must occur in its file
PARTS = {
    "wgmma": [("conv_mma.cuh",
               "mma::wgmma_m64n64k16(acc[mt], a[par][i][mt], desc);",
               "acc[mt][0] += __uint_as_float(a[par][i][mt][0]) + "
               "(float)desc;")],
    "ldmatrix": [("conv_mma.cuh",
                  "        mma::ldmatrix_x4(a[par][i][mt],",
                  "        if (b0 == 0) mma::ldmatrix_x4(a[par][i][mt],")],
    "copies": [("conv_mma.cuh",
                "if (ahead < nitems) fill(ahead, ahead % S);",
                "if (ahead < 0) fill(ahead, ahead % S);")],
    "epilogues": [
        ("double_conv3x3_relu.cu", "if (cur.chunk == nchunks1 - 1) {",
         "if (cur.chunk == nchunks1 - 1 && H < 0) {"),
        ("double_conv3x3_relu.cu", "if (cur.chunk == nchunks2 - 1) {",
         "if (cur.chunk == nchunks2 - 1 && H < 0) {"),
        ("conv3x3_bias_relu.cu",
         "    if (Q8 && cur.chunk == nchunks - 1) {",
         "    if (Q8 && cur.chunk == nchunks - 1 && H < 0) {"),
        ("conv3x3_bias_relu.cu", "    } else if (cur.chunk == nchunks - 1) {",
         "    } else if (cur.chunk == nchunks - 1 && H < 0) {")],
    # K2's s8 mode with its staged stores kept and its arithmetic taken
    # out: the s8 pair is two bytes of the accumulators' bits
    "q8 epilogue arithmetic": [
        ("conv3x3_bias_relu.cu", "  namespace s8 = cid::s8;\n"
         "  const uint32_t u = s8::add_bf16x2(",
         "  namespace s8 = cid::s8;\n"
         "  return s8::float_bits(acc0) ^ (s8::float_bits(acc1) << 8);\n"
         "  const uint32_t u = s8::add_bf16x2(")],
    # the int8 kernels K5 (conv3x3_s8.cu: wgmma, and mma.sync for Cout <= 8)
    # and K6 (convt2x2_s8.cu)
    "s8 mma": [("mma.cuh",
                "                                                   uint64_t desc,\n"
                "                                                   bool accumulate) {\n"
                "  asm volatile(",
                "                                                   uint64_t desc,\n"
                "                                                   bool accumulate) {\n"
                "  d[0] += (int)(a[0] ^ (uint32_t)desc) + accumulate;\n"
                "  if (d[1] != 12345) return;\n  asm volatile("),
               ("mma.cuh",
                "const uint32_t (&b)[2]) {\n  asm volatile(\n"
                "      \"mma.sync.aligned.m16n8k32",
                "const uint32_t (&b)[2]) {\n  d[0] += (int)(a[0] ^ b[0]);\n"
                "  if (d[1] != 12345) return;\n  asm volatile(\n"
                "      \"mma.sync.aligned.m16n8k32")],
    "s8 ldmatrix": [
        ("conv3x3_s8.cu", "        mma::ldmatrix_x4(a[par][i][mt],",
         "        if (b0 == 0) mma::ldmatrix_x4(a[par][i][mt],"),
        ("conv3x3_s8.cu",
         "mma::ldmatrix_x4(a[mt], s8::row_addr(st, pbase[mt] + shift, khalf));",
         "if (tap == 0) mma::ldmatrix_x4(a[mt], s8::row_addr(st, pbase[mt] "
         "+ shift, khalf));"),
        ("convt2x2_s8.cu", "        mma::ldmatrix_x4(a[c],",
         "        if (item < 0) mma::ldmatrix_x4(a[c],")],
    "s8 copies": [
        ("conv_mma.cuh", "if (ahead < nitems) fill(ahead, ahead % S);",
         "if (ahead < 0) fill(ahead, ahead % S);"),
        ("conv3x3_s8.cu", "if (item + 1 < nitems) fill(item + 1, stage ^ 1);",
         "if (item + 1 < 0) fill(item + 1, stage ^ 1);")],
    "s8 epilogue": [
        ("conv3x3_s8.cu", "    if (cur.chunk == nsteps - 1) {",
         "    if (cur.chunk == nsteps - 1 && H < 0) {"),
        ("conv3x3_s8.cu", "if (item % nchunks == nchunks - 1) {",
         "if (item % nchunks == nchunks - 1 && H < 0) {"),
        ("convt2x2_s8.cu",
         "    auto finish = [&](const int (&acc)[32], int nb) {\n",
         "    auto finish = [&](const int (&acc)[32], int nb) {\n"
         "      if (H > 0) return;\n")],
    # the epilogue's stores kept, its arithmetic taken out: h is the
    # accumulator's bits and the s8 pair two of its bytes
    "s8 epilogue arithmetic": [
        ("conv_s8.cuh", "bool relu, float& h0, float& h1) {\n",
         "bool relu, float& h0, float& h1) {\n"
         "  h0 = bits_float(acc0);\n  h1 = bits_float(acc1);\n"
         "  return;\n"),
        ("conv_s8.cuh", "                                              const Pair& k) {\n",
         "                                              const Pair& k) {\n"
         "  return float_bits(h0) ^ (float_bits(h1) << 8);\n")],
    # the f32 bodies' alternatives (each computes the right function)
    "k3 3-tap items at C1p 64": [("double_conv3x3_relu.cu",
                                  "  CID_TRY(16, 3, 9)\n", "")],
    "k3 16x16 tile at C1p 128": [("double_conv3x3_relu.cu",
                                  "  CID_TRY(8, 3, 9)\n",
                                  "  CID_TRY(16, 2, 3)\n  CID_TRY(8, 3, 9)\n")],
    "k3 12x16 tile at C1p 128": [("double_conv3x3_relu.cu",
                                  "  CID_TRY(8, 3, 9)\n",
                                  "  CID_TRY(12, 2, 9)\n  CID_TRY(8, 3, 9)\n")],
    "one accumulator": [
        ("conv3x3_bias_relu.cu",
         "mma::smem_u32(wst + stage * kW32Bytes), true);\n"
         "    conv::add_part(acc, part, cur.chunk == 0);",
         "mma::smem_u32(wst + stage * kW32Bytes), cur.chunk == 0);\n"
         "    conv::add_part(acc, part, true);"),
        ("double_conv3x3_relu.cu", "    const bool fresh = cur.row == 0;",
         "    const bool fresh = cur.row == 0 && cur.chunk == 0;"),
        ("double_conv3x3_relu.cu", "              if (!first_chunk) {",
         "              if (false) {"),
        ("double_conv3x3_relu.cu",
         "      if (last) conv::add_part(acc2, part2, cur.chunk == 0);",
         "      if (last) conv::add_part(acc2, part2, true);")],
    # K2's narrow f32 body (Cout <= 4): its parts, and the design's
    # alternatives (each computes the right function)
    "narrow copies": [("conv3x3_bias_relu.cu",
                       "  auto fill32 = [&](int item, int stage) {\n",
                       "  auto fill32 = [&](int item, int stage) {\n"
                       "    if (H > 0) return;\n")],
    "narrow FMAs": [("conv3x3_bias_relu.cu",
                     "    compute32(item % S, wr, acc);",
                     "    if (H < 0) compute32(item % S, wr, acc);")],
    "narrow epilogue": [("conv3x3_bias_relu.cu",
                         "if (chunk == nchunks - 1) store32(",
                         "if (chunk == nchunks - 1 && H < 0) store32(")],
    "narrow P 4": [("conv3x3_bias_relu.cu", "constexpr int kN32P = 16;",
                    "constexpr int kN32P = 4;")],
    "narrow P 8": [("conv3x3_bias_relu.cu", "constexpr int kN32P = 16;",
                    "constexpr int kN32P = 8;")],
    "narrow 4 stages": [("conv3x3_bias_relu.cu",
                         "constexpr int kN32Stages = 2;",
                         "constexpr int kN32Stages = 4;")],
    "narrow KC 32": [("conv3x3_bias_relu.cu", "constexpr int kN32KC = 64;",
                      "constexpr int kN32KC = 32;")],
    "narrow KC 16": [("conv3x3_bias_relu.cu", "constexpr int kN32KC = 64;",
                      "constexpr int kN32KC = 16;")],
}
# what each timed variant leaves out: the bf16 kernels (K2, K3) and K2's s8
# mode
VARIANTS = {
    "whole kernel": (),
    "no copies": ("copies",),
    "no epilogues": ("epilogues",),
    "stores only (no epilogue arithmetic; q8 only)": (
        "q8 epilogue arithmetic",),
    "no wgmma": ("wgmma",),
    "no wgmma, no copies": ("wgmma", "copies"),
    "no wgmma, no copies, no ldmatrix": ("wgmma", "copies", "ldmatrix"),
    "skeleton (none of the four)": ("wgmma", "copies", "ldmatrix",
                                    "epilogues"),
}
# the int8 kernels K5 and K6
S8_VARIANTS = {
    "whole kernel": (),
    "no copies": ("s8 copies",),
    "no epilogue": ("s8 epilogue",),
    "stores only (no epilogue arithmetic)": ("s8 epilogue arithmetic",),
    "no matrix instructions": ("s8 mma",),
    "no matrix instructions, no copies": ("s8 mma", "s8 copies"),
    "no mma, no copies, no ldmatrix": ("s8 mma", "s8 copies", "s8 ldmatrix"),
    "skeleton (none of the four)": ("s8 mma", "s8 copies", "s8 ldmatrix",
                                    "s8 epilogue"),
}


def patched_sources(parts) -> dict:
    """file name -> text of ``csrc/`` with ``parts`` patched out; raises if
    a patch no longer matches its source."""
    texts = {p.name: p.read_text() for p in _build.CSRC_DIR.iterdir()}
    for part in parts:
        for name, old, new in PARTS[part]:
            if old not in texts[name]:
                raise RuntimeError(f"ablation patch for {part!r} no longer "
                                   f"matches {name}")
            texts[name] = texts[name].replace(old, new)
    return texts


def _build_variant(out_dir: Path, parts, sources) -> subprocess.Popen:
    texts = patched_sources(parts)
    out_dir.mkdir(parents=True)
    for name, text in texts.items():
        (out_dir / name).write_text(text)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
           *(str(out_dir / s) for s in sources), "-o", str(out_dir / "lib.so")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the f32 bodies and their alternatives
F32_VARIANTS = {
    "as built": (),
    "K3: 3-tap items at C1p = 64": ("k3 3-tap items at C1p 64",),
    "K3: 16x16 tile, 3-tap items at C1p = 128": ("k3 16x16 tile at C1p 128",),
    "K3: 12x16 tile, 2 stages at C1p = 128": ("k3 12x16 tile at C1p 128",),
    "one wgmma accumulator, no chunk partials": ("one accumulator",),
}
# K2's narrow f32 body: as built, the alternatives, and parts patched out
NARROW_VARIANTS = {
    "as built": (),
    "runs of 8 pixels (8x16 tiles), 4 stages": ("narrow P 8",
                                                "narrow 4 stages"),
    "runs of 4 pixels (8x8 tiles)": ("narrow P 4",),
    "32-channel chunks (16x32 tiles)": ("narrow KC 32",),
    "16-channel chunks (32x32 tiles)": ("narrow KC 16",),
    "no copies": ("narrow copies",),
    "no FMAs (nor their shared-memory loads)": ("narrow FMAs",),
    "no epilogue": ("narrow epilogue",),
    "skeleton (none of the three)": ("narrow copies", "narrow FMAs",
                                     "narrow epilogue"),
}
F32_SIZE = 512
K3_F32 = {"down1": (1, F32_SIZE, F32_SIZE, 3, 64, 64),
          "down2": (1, F32_SIZE // 2, F32_SIZE // 2, 64, 128, 128),
          "bottleneck": (1, F32_SIZE // 4, F32_SIZE // 4, 128, 256, 256),
          "upconv2": (1, F32_SIZE // 2, F32_SIZE // 2, 256, 128, 128),
          "dncnn 5+8": (1, F32_SIZE, F32_SIZE, 64, 64, 64)}
K2_F32 = {"upconv1.0": (1, F32_SIZE, F32_SIZE, 128, 64, 1),
          "block conv": (1, F32_SIZE, F32_SIZE, 64, 64, 0)}


def _f32_calls(gen):
    """layer -> (C function name, its arguments, the output, the plain
    version's output) for the f32 bodies, with their split weights."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3, double_conv

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    calls = {}
    for layer, (n, h, w, c0, c1, c2) in K3_F32.items():
        x, b1, b2 = rnd((n, h, w, c0)), rnd((c1,), 0.1), rnd((c2,), 0.1)
        w1 = rnd((3, 3, c0, c1), (9 * c0) ** -0.5)
        w2 = rnd((3, 3, c1, c2), (9 * c1) ** -0.5)
        y = torch.empty((n, h, w, c2), device="cuda")
        calls[layer] = ("cid_double_conv3x3_relu_tf32", [
            x, None, conv3x3.tf32_weights(w1), b1, conv3x3.tf32_weights(w2),
            b2, y, n, h, w, c0, 0, c1, c2, 0, 0, 0, None], y,
            double_conv.double_conv3x3_relu_plain(x, w1, b1, w2, b2))
    for layer, (n, h, w, cin, cout, relu) in K2_F32.items():
        x, b = rnd((n, h, w, cin)), rnd((cout,), 0.1)
        k = rnd((3, 3, cin, cout), (9 * cin) ** -0.5)
        y = torch.empty((n, h, w, cout), device="cuda")
        calls[layer] = ("cid_conv3x3_bias_relu_tf32", [
            x, None, conv3x3.tf32_weights(k), b, y, n, h, w, cin, 0, cout,
            relu, 0, 0, 0, None], y,
            conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=bool(relu)))
    return calls


# the narrow rows: (N, H, W, Cin, Cout, zero bias)
NARROW = {"upconv1.2": (1, F32_SIZE, F32_SIZE, 64, 3, False),
          "dncnn body.47": (1, F32_SIZE, F32_SIZE, 64, 3, True),
          "cgan tail": (1, 2048, 2048, 64, 3, False)}


def _narrow_calls(gen):
    """The same for K2's narrow f32 body at its three rows (no ReLU)."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3

    calls = {}
    for layer, (n, h, w, cin, cout, nobias) in NARROW.items():
        x = torch.randn((n, h, w, cin), generator=gen, device="cuda")
        k = torch.randn((3, 3, cin, cout), generator=gen,
                        device="cuda") * (9 * cin) ** -0.5
        b = (torch.zeros(cout, device="cuda") if nobias else
             torch.randn((cout,), generator=gen, device="cuda") * 0.1)
        y = torch.empty((n, h, w, cout), device="cuda")
        calls[layer] = ("cid_conv3x3_bias_relu", [
            x, None, k, b, y, n, h, w, cin, 0, cout, 0, 0, 0, 0,
            _build.dtype_code(torch.float32), None], y,
            conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=False))
    return calls


def _bf16_calls(rnd):
    """layer -> (C function name, its arguments; tensors stand for their
    pointers) for the bf16 kernels and K2's s8 mode; one input each: a null
    second input, zero channels."""
    code = _build.dtype_code(torch.bfloat16)
    calls = {}
    for layer, (n, h, w, c0, c1, c2) in K3.items():
        calls[layer] = ("cid_double_conv3x3_relu", [
            rnd((n, h, w, c0)), None, rnd((3, 3, c0, c1), (9 * c0) ** -0.5),
            rnd((c1,), 0.1, torch.float32),
            rnd((3, 3, c1, c2), (9 * c1) ** -0.5),
            rnd((c2,), 0.1, torch.float32),
            torch.empty((n, h, w, c2), dtype=torch.bfloat16, device="cuda"),
            n, h, w, c0, 0, c1, c2, 0, 0, 0, code, None])
    for layer, (n, h, w, cin, cout, relu) in K2.items():
        calls[layer] = ("cid_conv3x3_bias_relu", [
            rnd((n, h, w, cin)), None, rnd((3, 3, cin, cout), (9 * cin) ** -0.5),
            rnd((cout,), 0.1, torch.float32),
            torch.empty((n, h, w, cout), dtype=torch.bfloat16, device="cuda"),
            n, h, w, cin, 0, cout, relu, 0, 0, 0, code, None])
    for layer, (n, h, w, cin, cout, relu) in Q8.items():
        calls[layer] = ("cid_conv3x3_bias_relu_q8", [
            rnd((n, h, w, cin)), rnd((3, 3, cin, cout), (9 * cin) ** -0.5),
            rnd((cout,), 0.1, torch.float32),
            torch.full((cout,), 3.0 / 127, device="cuda"),
            torch.empty((n, h, w, cout), dtype=torch.int8, device="cuda"),
            n, h, w, cin, cout, relu, None])
    return calls


def _s8_calls(gen):
    """The same for K5 and K6 at the int8 step's layers: s8 operands over
    the whole range, scales that spread the products across the s8 range
    (about half of them zero after ReLU, as in the program)."""
    def s8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def consts(terms, cout):  # terms: products in one output's sum
        ws = torch.full((cout,), 3.0 / (terms ** 0.5 * 127 * 127 / 3),
                        device="cuda")
        bias = (torch.randn((cout,), generator=gen, device="cuda")
                * 0.1).to(torch.bfloat16)
        return ws, bias, torch.full((cout,), 3.0 / 127, device="cuda")

    calls = {}
    for layer, (n, h, w, ca, cb, cout, relu, mode) in K5.items():
        ws, bias, so = consts(9 * (ca + cb), cout)
        x2 = s8((n, h, w, cb)) if cb else None
        y = torch.empty((n, h, w, cout), device="cuda",
                        dtype=torch.int8 if mode == 0 else torch.bfloat16)
        calls[layer] = ("cid_conv3x3_s8", [
            s8((n, h, w, ca)), x2, s8((cout, 3, 3, ca + cb)), ws, bias,
            so if mode == 0 else None, y, n, h, w, ca, cb, cout, relu, mode,
            *((0, 0, 0) if x2 is None else x2.stride()[:3]), None])
    for layer, (n, h, w, cin, cout) in K6.items():
        ws, bias, so = consts(cin, cout)
        calls[layer] = ("cid_convt2x2_s8", [
            s8((n, h, w, cin)), s8((2, 2, cout, cin)), ws, bias, so,
            torch.empty((n, 2 * h, 2 * w, cout), dtype=torch.int8,
                        device="cuda"), n, h, w, cin, cout, 0, None])
    return calls


# group -> (its variants, the sources a variant library is built from)
GROUPS = {"bf16": (VARIANTS, ("conv3x3_bias_relu.cu",
                              "double_conv3x3_relu.cu")),
          "s8": (S8_VARIANTS, ("conv3x3_s8.cu", "convt2x2_s8.cu")),
          "f32": (F32_VARIANTS, ("conv3x3_bias_relu.cu",
                                 "double_conv3x3_relu.cu")),
          "f32 narrow": (NARROW_VARIANTS, ("conv3x3_bias_relu.cu",
                                           "double_conv3x3_relu.cu"))}
# --only: the groups it runs (f32: both f32 groups)
ONLY = {"bf16": ("bf16",), "s8": ("s8",), "f32": ("f32", "f32 narrow"),
        "narrow": ("f32 narrow",)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=sorted(ONLY),
                    help="time one group of kernels (default: all; f32: "
                         "the wide and the narrow f32 bodies, narrow: the "
                         "narrow one alone)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablation: needs an NVIDIA card", file=sys.stderr)
        return 2
    # the f32 group's plain versions are f32 convs, not TF32 ones
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    groups = list(ONLY[args.only]) if args.only else list(GROUPS)
    with tempfile.TemporaryDirectory(prefix="cid_ablation_") as tmp:
        # every variant of every group builds at once
        procs = {(g, name): _build_variant(Path(tmp) / _dir(g, i), parts,
                                           GROUPS[g][1])
                 for g in groups
                 for i, (name, parts) in enumerate(GROUPS[g][0].items())}
        for g in groups:
            calls = (_bf16_calls(rnd) if g == "bf16" else _s8_calls(gen)
                     if g == "s8" else _f32_calls(gen) if g == "f32"
                     else _narrow_calls(gen))
            _time_group(g, calls, procs, Path(tmp))
            del calls
            torch.cuda.empty_cache()
    return 0


def _dir(group: str, i: int) -> str:
    """The build directory of a group's i-th variant."""
    return f"{group.replace(' ', '_')}{i}"


def _time_group(group, calls, procs, tmp: Path) -> None:
    print(f"{'ms per launch':38s}" + "".join(f"{k:>13s}" for k in calls),
          flush=True)
    for i, name in enumerate(GROUPS[group][0]):
        proc = procs[(group, name)]
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(tmp / _dir(group, i) / "lib.so"))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if group == "f32":
            lib.cid_conv3x3_bias_relu_tf32.argtypes = (
                [P] * 5 + [I] * 7 + [L] * 3 + [P])
            lib.cid_double_conv3x3_relu_tf32.argtypes = (
                [P] * 7 + [I] * 7 + [L] * 3 + [P])
        elif group == "f32 narrow":
            lib.cid_conv3x3_bias_relu.argtypes = (
                [P] * 5 + [I] * 7 + [L] * 3 + [I, P])
        elif group == "bf16":
            lib.cid_conv3x3_bias_relu.argtypes = (
                [P] * 5 + [I] * 7 + [L] * 3 + [I, P])
            lib.cid_double_conv3x3_relu.argtypes = (
                [P] * 7 + [I] * 7 + [L] * 3 + [I, P])
            lib.cid_conv3x3_bias_relu_q8.argtypes = [P] * 5 + [I] * 6 + [P]
        else:
            lib.cid_conv3x3_s8.argtypes = [P] * 7 + [I] * 8 + [L] * 3 + [P]
            lib.cid_convt2x2_s8.argtypes = [P] * 6 + [I] * 6 + [P]
        row, errs = [], []
        for fn_name, spec, *checked in calls.values():
            fn = getattr(lib, fn_name)
            args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in spec]
            _build.check(fn(*args), f"{fn_name} ({name})")
            if checked:  # (output, plain version's output)
                y, ref = checked
                errs.append(((y - ref).abs().max()
                             / ref.abs().max()).item())
            # the narrow body's launches are short: timed on the device's
            # clock, so that no host time between launches counts
            timer = (timing.device_ms if group == "f32 narrow"
                     else _time_ms)
            row.append(timer(lambda: fn(*args)))
        print(f"{name:38s}" + "".join(f"{ms:13.3f}" for ms in row),
              flush=True)
        if errs:
            print(f"{'  max|err| / max|ref|':38s}"
                  + "".join(f"{e:13.2e}" for e in errs), flush=True)


if __name__ == "__main__":
    sys.exit(main())
