"""Where the bf16 conv kernels' time goes: the kernels timed with parts
taken out.

    python3 -m celebrity_image_denoiser_tpu_torch.ops.cuda.ablation

Builds variants of ``csrc/conv3x3_bias_relu.cu`` and
``csrc/double_conv3x3_relu.cu`` in which one or more parts are patched out
of the source text (the matrix instructions, the ldmatrix loads, the
producers' copies, the epilogues), and times each variant at the bench
shapes (bf16, 128², batch 256) on the card, and K2's s8-out mode at the int8
step's first conv (``down1.0 q8``).  A variant's results are wrong;
only its time is read: what a part costs is the time that goes away with
it, and what is left when everything is out is the ring's skeleton (barriers
and bookkeeping).  Where ncu and nsys cannot run, this takes the place of
a kernel profile.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

BATCH = 256
# layer: (N, H, W, C0, C1, C2) for the double conv, (N, H, W, Cin, Cout,
# relu) for the single conv
K3 = {"down1": (BATCH, 128, 128, 3, 64, 64),
      "down2": (BATCH, 64, 64, 64, 128, 128),
      "bottleneck": (BATCH, 32, 32, 128, 256, 256),
      "upconv2": (BATCH, 64, 64, 256, 128, 128)}
K2 = {"upconv1.0": (BATCH, 128, 128, 128, 64, 1)}
Q8 = {"down1.0 q8": (BATCH, 128, 128, 3, 64, 1)}  # K2, s8 out

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
        ("conv3x3_bias_relu.cu", "    if (cur.chunk == nchunks - 1) {\n"
         "      const int n0 = cur.pass * conv::kNB;",
         "    if (cur.chunk == nchunks - 1 && H < 0) {\n"
         "      const int n0 = cur.pass * conv::kNB;")],
}
# what each timed variant leaves out
VARIANTS = {
    "whole kernel": (),
    "no copies": ("copies",),
    "no epilogues": ("epilogues",),
    "no wgmma": ("wgmma",),
    "no wgmma, no copies": ("wgmma", "copies"),
    "no wgmma, no copies, no ldmatrix": ("wgmma", "copies", "ldmatrix"),
    "skeleton (none of the four)": ("wgmma", "copies", "ldmatrix",
                                    "epilogues"),
}


def _build_variant(out_dir: Path, parts) -> subprocess.Popen:
    texts = {p.name: p.read_text() for p in _build.CSRC_DIR.iterdir()}
    for part in parts:
        for name, old, new in PARTS[part]:
            if old not in texts[name]:
                raise RuntimeError(f"ablation patch for {part!r} no longer "
                                   f"matches {name}")
            texts[name] = texts[name].replace(old, new)
    out_dir.mkdir(parents=True)
    for name, text in texts.items():
        (out_dir / name).write_text(text)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
           str(out_dir / "conv3x3_bias_relu.cu"),
           str(out_dir / "double_conv3x3_relu.cu"), "-o",
           str(out_dir / "lib.so")]
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ablation: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    # layer -> (C function name, its arguments; tensors stand for their
    # pointers); one input each: a null second input, zero channels
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

    with tempfile.TemporaryDirectory(prefix="cid_ablation_") as tmp:
        procs = {name: _build_variant(Path(tmp) / f"v{i}", parts)
                 for i, (name, parts) in enumerate(VARIANTS.items())}
        print(f"{'ms per launch':34s}" + "".join(f"{k:>12s}" for k in calls),
              flush=True)
        for i, (name, proc) in enumerate(procs.items()):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-4000:]}")
            lib = ctypes.CDLL(str(Path(tmp) / f"v{i}" / "lib.so"))
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cid_conv3x3_bias_relu.argtypes = (
                [P] * 5 + [I] * 7 + [L] * 3 + [I, P])
            lib.cid_double_conv3x3_relu.argtypes = (
                [P] * 7 + [I] * 7 + [L] * 3 + [I, P])
            lib.cid_conv3x3_bias_relu_q8.argtypes = [P] * 5 + [I] * 6 + [P]
            row = []
            for fn_name, spec in calls.values():
                fn = getattr(lib, fn_name)
                args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                        for a in spec]
                _build.check(fn(*args), f"{fn_name} ({name})")
                row.append(_time_ms(lambda: fn(*args)))
            print(f"{name:34s}" + "".join(f"{ms:12.3f}" for ms in row),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
