"""The ``restormer`` configuration and its cell ``restormer.requests1024``
on the CPU: its files found by name, its configuration equal to what the
port serves, its plain reference's seeded weights equal to the port's, a
whole run at a small size judged correct, the TF32 control judged not
correct, and its three per-layer readers on made-up traces."""

import numpy as np
import pytest
import torch

from port_bench import gen, harness, roofline, roofline_restormer

WORKLOAD = "restormer.requests1024"
# 64 x 64: one count off in one value of an image reads 8.1e-5, under the
# limit of 3e-4 that 1024 x 1024 images are held to (at 32 x 32 it would
# read 3.3e-4)
SMALL = {"size": 64, "pool": 2, "rate_per_s": 30, "workers": 2,
         "warm_requests": 1}


@pytest.fixture(scope="module")
def cell():
    return harness.Cell(harness.load_benchmark(), WORKLOAD, 2 ** 31 + 9,
                        "cpu")


def test_the_cell_and_its_files_are_found_by_name(cell):
    bench = harness.load_benchmark()
    assert cell.entry["config"] == "restormer" and cell.entry["chips"] == 1
    assert cell.traffic["loop"] == "requests"
    assert cell.traffic["size"] == 1024 and cell.traffic["workers"] == 4
    assert cell.config["family"] == "restormer"
    assert cell.config["precision"] == "f32"
    assert cell.config["control"] == "tf32" and cell.config["rung"] is None
    assert hasattr(cell.reference(), "Reference")
    mine = {m["name"] for m in harness.per_layer_for(bench, WORKLOAD)}
    assert mine == {"mfu.restormer", "roofline.k7.restormer",
                    "roofline.k8.restormer"}
    assert {m["name"] for m in harness.end_to_end_for(bench, WORKLOAD)} == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    config = next(c for c in bench["configs"] if c["name"] == "restormer")
    assert config["reduced"] == [] == cell.config["reduced"]


def test_the_configuration_is_what_the_port_serves(cell):
    from celebrity_image_denoiser_tpu_torch.core.config import MODEL_CFG
    from celebrity_image_denoiser_tpu_torch.models.restormer import (
        Restormer,
    )

    port = MODEL_CFG["restormer"]
    cfg = cell.config
    assert cfg["init_seed"] == port["init_seed"]
    assert tuple(cfg["temperature_range"]) == port["temperature_range"]
    assert cfg["output_scale"] == port["output_scale"]
    assert cfg["pad_divisor"] == port["pad_divisor"]
    assert port["normalize"] is None and cfg["domain"] == "[0,1]"
    arch = {k: cfg["arch"][k] for k in (
        "dim", "num_blocks", "num_refinement_blocks", "heads",
        "ffn_expansion_factor")}
    served = Restormer(**arch, init_seed=port["init_seed"],
                       temperature_range=port["temperature_range"],
                       output_scale=port["output_scale"]).state_dict()
    model = cell.reference().Reference(cfg, "cpu").model
    got = model.state_dict()
    assert list(got) == list(served)
    assert sum(v.numel() for v in got.values()) == cfg["parameters"]
    for k, v in served.items():
        assert torch.equal(v, got[k]), k


def run(hook=None, seed=2 ** 31 + 21):
    return harness.run(WORKLOAD, seed, 0.3, False, 0.0, device="cpu",
                       overrides=SMALL, hook=hook)


def test_a_small_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["images_compared"]["value"] >= 1
    assert set(r["metrics"]) == {"latency_p50_ms", "latency_p95_ms",
                                 "setup_s"}


def test_the_tf32_control_is_not_correct():
    """The reference with every conv's and matmul's operands rounded to
    TF32 (on the CPU by rounding them) in the timed program's place: its
    served images miss the limit."""
    r = run(harness.control)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert not r["correct"]
    assert not r["_checks"]["worst_image_mad"]["ok"]


def test_the_reference_serves_odd_sizes_padded_and_cropped(cell):
    ref = cell.reference().Reference(cell.config, "cpu")
    u8 = gen.noisy_u8(3, 1, 20, 0.1, "cpu")[:, :13, :20]
    y = ref(u8)
    assert y.shape == u8.shape and y.dtype == torch.uint8


def ctx(requests, ops, config, size=1024, busy=2.0):
    return {"trace": {"busy_s": busy, "window_s": 10.0,
                      "breakdown": {"device_ops": ops}},
            "work": {"requests": requests, "images": requests},
            "config": config, "traffic": {"size": size}}


def test_the_readers_on_made_up_traces(cell):
    k7 = harness.load_module(harness.BENCH_DIR / "metrics"
                             / "roofline.k7.restormer.py")
    k8 = harness.load_module(harness.BENCH_DIR / "metrics"
                             / "roofline.k8.restormer.py")
    mfu = harness.load_module(harness.BENCH_DIR / "metrics"
                              / "mfu.restormer.py")
    arch = cell.config["arch"]
    ops = [["void (anonymous namespace)::mdta_attention_kernel(float "
            "const*, ...)", 0.5],
           ["void (anonymous namespace)::dwconv3x3_f32_kernel<true>(...)",
            0.6],
           ["void (anonymous namespace)::dwconv3x3_f32_kernel<false>(...)",
            0.4], ["Memcpy HtoD (Pageable -> Device)", 0.1]]
    c = ctx(40, ops, cell.config)
    bound7 = sum(b for *_, b in roofline_restormer.k7_launches(arch, 1024,
                                                               1024))
    bound8 = sum(b for *_, b in roofline_restormer.k8_launches(arch, 1024,
                                                               1024))
    assert k7.read(c) == pytest.approx(100 * 40 * bound7 / 0.5)
    assert k8.read(c) == pytest.approx(100 * 40 * bound8 / 1.0)
    flops = roofline_restormer.forward_flops(arch, 1024, 1024)
    assert mfu.read(c) == pytest.approx(
        100 * flops * 40 / 2.0 / roofline.PEAK_TF32_FLOPS)
    # fewer than 30 requests, or no record of the kernel: nothing to read
    assert k7.read(ctx(29, ops, cell.config)) is None
    assert k8.read(ctx(40, ops[:1], cell.config)) is None
    assert k7.read(ctx(40, ops[1:], cell.config)) is None


def test_the_counts_at_the_published_widths(cell):
    arch = cell.config["arch"]
    # 2.36 M multiply-adds a pixel (the published equations)
    flops = roofline_restormer.forward_flops(arch, 1024, 1024)
    assert flops / 2 / 1024 ** 2 == pytest.approx(2.3633e6, rel=1e-4)
    assert len(roofline_restormer.k7_launches(arch, 64, 64)) == 44
    assert len(roofline_restormer.k8_launches(arch, 64, 64)) == 88
    # at full resolution GDFN's depthwise conv reads 510 and writes 255
    # channels: bound by its bytes
    ops, nbytes, bound = roofline_restormer.k8_launches(arch, 1024, 1024)[-1]
    assert nbytes == 4 * (1024 ** 2 * (510 + 255) + 9 * 510)
    assert bound == pytest.approx(nbytes / roofline.PEAK_BYTES)
    assert np.isclose(ops, 2 * 1024 ** 2 * 9 * 510)
