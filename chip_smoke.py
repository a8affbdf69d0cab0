#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py        (from the repo root; needs one CUDA card)

Phases, each printing its own lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi) and torch's view;
2. build   — compile ``celebrity_image_denoiser_tpu_torch/csrc`` with nvcc
             for sm_90a (one nvcc per source, started together);
3. kernels — every kernel entry point against its plain PyTorch version on
             the card, at every shape the U-Net launches at 128² batch 8 and
             at a ragged 132×100 input (tiles straddle every edge), in f32
             and bf16, TF32 off; then, as a control, the f32 plain versions
             with TF32 on must fail the f32 check at 128² batch 8;
4. serve   — the port's ``ServeState`` on the shipped weights behind the
             stdlib HTTP server on 127.0.0.1; three ``/enhance`` requests
             (256×256, 130×98, 64×64) whose pixels must match the plain-path
             forward on the card within 1 count, and whose kernel launch
             counts must be exactly 4 (double conv) + 2 (single conv) each;
             then 100 more 256×256 requests from one client for p50/p90
             latency;
5. bench   — the port's bench line at batch 256, whose kernel launch counts
             must be exactly 4 (double conv) + 2 (single conv) per step; then
             each kernel at the bench shapes (bf16, 128², batch 256) checked
             against its plain version and timed beside it, beside one cuDNN
             call for the same function (``library_ms``, a yardstick the port
             never calls) and its bound: the larger of its operations at 989
             TFLOP/s (dense bf16) and its bytes (each input read once, each
             output written once) at 3.35 TB/s;
6. batch   — one bf16 forward at the JAX bench's batch of 2048, where
             down1's output holds 2^31 elements and upconv1's input 2^32,
             checked against the plain forward (64-bit indexing);
7. profile — one bench step under torch.profiler: device time by kernel and
             the device's busy share of the step.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import base64
import functools
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# × max|ref|.  f32: the kernels differ from the plain versions by summation
# order only (≤ 1.5e-6 on the card); TF32 operands (10-bit mantissa) miss by
# far more, so a kernel that quietly used TF32 fails.  bf16: two ulps.
TOL = {torch.float32: 3e-5, torch.bfloat16: 1.6e-2}
BENCH_BATCH = 256
BIG_BATCH = 2048  # the JAX bench's batch: tensors beyond 2^31 elements
LATENCY_REQUESTS = 100  # p90 then has 10 samples beyond it
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
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


# ---------------------------------------------------------------------------
# the U-Net's kernel shapes: (N, H, W, C0, C1, C2) for the double conv,
# (N, H, W, Cin, Cout, relu) for the single conv, at an input of H x W
def pair_shapes(n, h, w):
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    return {"down1": (n, h, w, 3, 64, 64), "down2": (n, h2, w2, 64, 128, 128),
            "bottleneck": (n, h4, w4, 128, 256, 256),
            "upconv2": (n, h2, w2, 256, 128, 128)}


def single_shapes(n, h, w):
    return {"upconv1.0": (n, h, w, 128, 64, True),
            "upconv1.2": (n, h, w, 64, 3, False)}


def make_gen():
    return torch.Generator(device="cuda").manual_seed(SEED)


def rnd(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def single_inputs(gen, shape, dtype):
    n, h, w, cin, cout, relu = shape
    return (rnd(gen, (n, h, w, cin), dtype),
            rnd(gen, (3, 3, cin, cout), dtype, (9 * cin) ** -0.5),
            rnd(gen, (cout,), torch.float32, 0.1)), relu


def pair_inputs(gen, shape, dtype):
    n, h, w, c0, c1, c2 = shape
    return (rnd(gen, (n, h, w, c0), dtype),
            rnd(gen, (3, 3, c0, c1), dtype, (9 * c0) ** -0.5),
            rnd(gen, (c1,), torch.float32, 0.1),
            rnd(gen, (3, 3, c1, c2), dtype, (9 * c1) ** -0.5),
            rnd(gen, (c2,), torch.float32, 0.1))


def phase_device():
    say("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build(_build):
    say("== phase 2: build")
    res = _build.build()
    say(f"built {res.path.name} in {res.seconds:.1f} s"
        f"{' (cached)' if res.cached else ''}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            say("  " + line.strip())
    _build.library()


def phase_kernels(conv3x3, double_conv):
    say("== phase 3: kernels vs plain (TF32 off)")
    gen = make_gen()
    worst = {"conv3x3_bias_relu": 0.0, "double_conv3x3_relu": 0.0}
    controls = []  # (layer, shape, plain fn, args, f32 reference)
    shapes = [(8, 128, 128), (2, 132, 100)]
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w in shapes:
            control = dtype == torch.float32 and (n, h, w) == shapes[0]
            for layer, shape in pair_shapes(n, h, w).items():
                args = pair_inputs(gen, shape, dtype)
                got = double_conv.double_conv3x3_relu(*args)
                ref = double_conv.double_conv3x3_relu_plain(*args)
                worst["double_conv3x3_relu"] = max(
                    worst["double_conv3x3_relu"],
                    check("double_conv3x3_relu", layer, shape, dtype, got, ref))
                if control:
                    controls.append((layer, shape, functools.partial(
                        double_conv.double_conv3x3_relu_plain, *args), ref))
            for layer, shape in single_shapes(n, h, w).items():
                args, relu = single_inputs(gen, shape, dtype)
                ref = conv3x3.conv3x3_bias_relu_plain(*args, relu=relu)
                for entry in (conv3x3.conv3x3_bias_relu,
                              conv3x3.conv3x3_bias_relu_v2):
                    got = entry(*args, relu=relu)
                    worst["conv3x3_bias_relu"] = max(
                        worst["conv3x3_bias_relu"],
                        check(entry.__name__, layer, shape, dtype, got, ref))
                if control:
                    controls.append((layer, shape, functools.partial(
                        conv3x3.conv3x3_bias_relu_plain, *args, relu=relu),
                        ref))
    say("kernels: conv3x3_bias_relu, conv3x3_bias_relu_v2, "
        "double_conv3x3_relu")
    # control: the f32 check must reject TF32 in the kernels' place
    torch.backends.cudnn.allow_tf32 = True
    tf32 = [(layer, shape, fn(), ref) for layer, shape, fn, ref in controls]
    torch.backends.cudnn.allow_tf32 = False
    for layer, shape, got, ref in tf32:
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = TOL[torch.float32] * ref.abs().max().item()
        say(f"  TF32 control {layer:10s} {str(shape):30s} max_abs_err "
            f"{err:.3e} ({err / ref.abs().max().item():.2e} x max|ref|) tol "
            f"{tol:.3e} {'rejected' if err > tol else 'ACCEPTED'}")
        if not err > tol:
            fail(f"the f32 check accepts TF32 for {layer} {shape}")
    return worst


def check(name, layer, shape, dtype, got, ref) -> float:
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{name} {layer}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = TOL[dtype] * scale
    ok = err <= tol and bool(torch.isfinite(got.float()).all())
    say(f"  {name:22s} {layer:10s} {str(shape):30s} {str(dtype):15s} "
        f"max_abs_err {err:.3e} ({err / scale:.2e} x max|ref|) tol "
        f"{tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {layer} {shape} {dtype} disagrees with its plain version")
    return err


def test_image(h, w, seed):
    """A smooth face-sized pattern plus noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(xx / 17 + yy / 29),
                     128 + 80 * np.cos(yy / 13),
                     100 + 60 * np.sin((xx + yy) / 23)], -1)
    noisy = base + rng.normal(0, 20, base.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def post_enhance(url, png: bytes):
    boundary = "cidchipsmoke7d1f"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"x.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
    body += png + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def phase_serve(conv3x3, double_conv):
    from celebrity_image_denoiser_tpu_torch.data import imageio
    from celebrity_image_denoiser_tpu_torch.serve.app import make_server
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    say("== phase 4: serve (ServeState on the shipped weights, f32)")
    st = ServeState(device="cuda")
    if "denoise" not in st.healthz()["weights_loaded"]:
        fail("shipped denoise weights did not load")
    srv = make_server("127.0.0.1", 0, state=st)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{srv.server_address[1]}"
           "/enhance?model=denoise&graphs=false")
    totals = {"conv3x3_bias_relu": 0, "double_conv3x3_relu": 0}
    try:
        for i, (h, w) in enumerate(((256, 256), (98, 130), (64, 64))):
            img = test_image(h, w, seed=i)
            conv3x3.LAUNCHES = 0
            double_conv.LAUNCHES = 0
            t0 = time.perf_counter()
            status, payload = post_enhance(url, imageio.encode_png(img))
            dt = (time.perf_counter() - t0) * 1e3
            n1, n3 = conv3x3.LAUNCHES, double_conv.LAUNCHES
            totals["conv3x3_bias_relu"] += n1
            totals["double_conv3x3_relu"] += n3
            if status != 200:
                fail(f"/enhance {w}x{h}: HTTP {status} {payload}")
            if set(payload) != {"denoised_image_base64", "noise_graph_base64",
                                "backend"} or payload["backend"] != "torch":
                fail(f"/enhance {w}x{h}: bad payload keys {sorted(payload)}")
            out = imageio.decode_png(
                base64.b64decode(payload["denoised_image_base64"]))
            if out.shape != (h, w, 3):
                fail(f"/enhance {w}x{h}: output shape {out.shape}")
            ref = st.denoise_image(img, plain=True)
            diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            say(f"  /enhance {w}x{h}: 200 in {dt:.1f} ms, launches "
                f"double_conv {n3} conv3x3 {n1}, vs plain max diff "
                f"{diff.max()} exact {np.mean(diff == 0):.4%}")
            if diff.max() > 1:
                fail(f"/enhance {w}x{h}: served pixels differ from the plain "
                     f"forward by {diff.max()}")
            if (n3, n1) != (4, 2):
                fail(f"/enhance {w}x{h}: launches double_conv {n3} conv3x3 "
                     f"{n1}, expected 4 and 2")
        # request latency as a closed loop of one client, 256x256 PNG
        png = imageio.encode_png(test_image(256, 256, seed=9))
        lat = []
        for _ in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            status, _ = post_enhance(url, png)
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                fail(f"/enhance latency loop: HTTP {status}")
        p50, p90 = np.percentile(lat, [50, 90])
        say(f"  /enhance 256x256 latency over {len(lat)} requests (one "
            f"client, graphs=false): p50 {p50:.2f} ms p90 {p90:.2f} ms "
            f"max {max(lat):.2f} ms")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return totals


def bound_ms(flops, nbytes, peak_flops):
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def phase_bench(conv3x3, double_conv, bench, worst):
    import torch.nn.functional as F

    say(f"== phase 5: bench (batch {BENCH_BATCH}) and kernel times")
    steps = 1 + bench.N_ITERS  # the warm-up step, then the timed ones
    conv3x3.LAUNCHES = 0
    double_conv.LAUNCHES = 0
    bench.main(batch=BENCH_BATCH)
    n1, n3 = conv3x3.LAUNCHES, double_conv.LAUNCHES
    say(f"  bench launches over {steps} steps: double_conv {n3} conv3x3 {n1}")
    if (n3, n1) != (4 * steps, 2 * steps):
        fail(f"bench: launches double_conv {n3} conv3x3 {n1}, expected "
             f"{4 * steps} and {2 * steps}")
    launches = {"conv3x3_bias_relu": n1, "double_conv3x3_relu": n3}
    gen = make_gen()
    dt = torch.bfloat16
    n, h, w = BENCH_BATCH, bench.SIZE, bench.SIZE
    stats = {}

    def add(name, ms, plain, lib, flops, nbytes):
        s = stats.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": 0.0, "bound_ms": 0.0,
                                    "operations": 0.0, "bytes": 0.0,
                                    "per_step": 0})
        s["per_step"] += 1
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        s["ms"] += ms
        s["plain_ms"] += plain
        s["library_ms"] += lib
        s["bound_ms"] += max(ops_ms, bytes_ms)
        # each launch's bound is credited to the side that sets it
        s["operations" if ops_ms >= bytes_ms else "bytes"] += max(
            ops_ms, bytes_ms)

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def oihw(k):
        return k.permute(3, 2, 0, 1).contiguous()

    for layer, shape in pair_shapes(n, h, w).items():
        x, w1, b1, w2, b2 = pair_inputs(gen, shape, dt)
        _, hh, ww, c0, c1, c2 = shape
        k1, k2, bb1, bb2 = oihw(w1), oihw(w2), b1.to(dt), b2.to(dt)
        worst["double_conv3x3_relu"] = max(
            worst["double_conv3x3_relu"],
            check("double_conv3x3_relu", layer, shape, dt,
                  double_conv.double_conv3x3_relu(x, w1, b1, w2, b2),
                  double_conv.double_conv3x3_relu_plain(x, w1, b1, w2, b2)))
        ms = time_ms(lambda: double_conv.double_conv3x3_relu(x, w1, b1, w2, b2))
        plain = time_ms(lambda: double_conv.double_conv3x3_relu_plain(
            x, w1, b1, w2, b2))
        lib = time_ms(lambda: F.relu(F.conv2d(
            F.relu(F.conv2d(nchw(x), k1, bb1, padding=1)), k2, bb2, padding=1)))
        flops = 2 * n * hh * ww * 9 * (c0 * c1 + c1 * c2)
        nbytes = 2 * (x.numel() + w1.numel() + w2.numel() + n * hh * ww * c2) \
            + 4 * (c1 + c2)
        add("double_conv3x3_relu", ms, plain, lib, flops, nbytes)
        say(f"  double_conv3x3_relu {layer:10s} {str(shape):30s} kernel "
            f"{ms:.3f} ms plain {plain:.3f} ms cudnn {lib:.3f} ms bound "
            f"{bound_ms(flops, nbytes, PEAK_BF16_FLOPS):.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)")
    for layer, shape in single_shapes(n, h, w).items():
        (x, k, b), relu = single_inputs(gen, shape, dt)
        _, hh, ww, cin, cout, _ = shape
        ko, bb = oihw(k), b.to(dt)
        act = F.relu if relu else (lambda t: t)
        worst["conv3x3_bias_relu"] = max(
            worst["conv3x3_bias_relu"],
            check("conv3x3_bias_relu", layer, shape, dt,
                  conv3x3.conv3x3_bias_relu(x, k, b, relu=relu),
                  conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=relu)))
        ms = time_ms(lambda: conv3x3.conv3x3_bias_relu(x, k, b, relu=relu))
        plain = time_ms(lambda: conv3x3.conv3x3_bias_relu_plain(
            x, k, b, relu=relu))
        lib = time_ms(lambda: act(F.conv2d(nchw(x), ko, bb, padding=1)))
        flops = 2 * n * hh * ww * 9 * cin * cout
        nbytes = 2 * (x.numel() + k.numel() + n * hh * ww * cout) + 4 * cout
        add("conv3x3_bias_relu", ms, plain, lib, flops, nbytes)
        say(f"  conv3x3_bias_relu   {layer:10s} {str(shape):30s} kernel "
            f"{ms:.3f} ms plain {plain:.3f} ms cudnn {lib:.3f} ms bound "
            f"{bound_ms(flops, nbytes, PEAK_BF16_FLOPS):.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)")
    for name, s in stats.items():
        say(f"  {name}: {s['per_step']} launches per step, kernel "
            f"{s['ms']:.3f} ms, plain {s['plain_ms']:.3f} ms, cudnn "
            f"{s['library_ms']:.3f} ms, bound {s['bound_ms']:.3f} ms per step")
    return stats, launches


def phase_big_batch(bench):
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        _BF16_2_OVER_255,
        DenoiseGenerator,
    )

    say(f"== phase 6: one forward at batch {BIG_BATCH} (bf16) vs plain")
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    gen = make_gen()
    x = torch.randint(0, 256, (BIG_BATCH, bench.SIZE, bench.SIZE, 3),
                      generator=gen, dtype=torch.uint8, device="cuda")
    x = (x.to(torch.bfloat16) * _BF16_2_OVER_255 - 1.0).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = model(x)
        ref = model(x, plain=True)
    check("DenoiseGenerator", f"b{BIG_BATCH}", tuple(x.shape),
          torch.bfloat16, got, ref)


def phase_profile(bench):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseGenerator,
        serve_step,
    )

    say(f"== phase 7: profile of one bench step (batch {BENCH_BATCH})")
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    x = torch.randint(0, 256, (BENCH_BATCH, bench.SIZE, bench.SIZE, 3),
                      dtype=torch.uint8, device="cuda")
    serve_step(model, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_step(model, x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only, so no kernel is counted twice
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        say("  profiler saw no device time: not measured")
        return
    say(f"  step wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({busy / wall:.1%} of the step; idle {1 - busy / wall:.1%})")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        say(f"  {ms:9.3f} ms {ms / busy:6.1%} x{count:<3d} {key[:90]}")


def main() -> int:
    # the port first: run outside a checkout, this fails before anything
    from celebrity_image_denoiser_tpu_torch import bench
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        _build,
        conv3x3,
        double_conv,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr, flush=True)
        return 2
    # the plain versions are the reference: full f32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_device()
    phase_build(_build)
    worst = phase_kernels(conv3x3, double_conv)
    launches = phase_serve(conv3x3, double_conv)
    stats, bench_launches = phase_bench(conv3x3, double_conv, bench, worst)
    phase_big_batch(bench)
    phase_profile(bench)

    replaces = {
        "conv3x3_bias_relu":
            "celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py:143",
        "double_conv3x3_relu":
            "celebrity_image_denoiser_tpu/ops/pallas/double_conv.py:108",
    }
    kernels = []
    for name in ("conv3x3_bias_relu", "double_conv3x3_relu"):
        if launches[name] < 1 or bench_launches[name] < 1:
            fail(f"{name} was not launched on the main path")
        s = stats[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"celebrity_image_denoiser_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            # both main paths: the /enhance requests and the bench run
            "launches": launches[name] + bench_launches[name],
            "max_abs_err": worst[name],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if s["operations"] >= s["bytes"]
                         else "bytes"),
            "library_ms": s["library_ms"],
        }
        if name == "conv3x3_bias_relu":
            entry["also_replaces"] = (
                "celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py:85")
        kernels.append(entry)
    say(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
