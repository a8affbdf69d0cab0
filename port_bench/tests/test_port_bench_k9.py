"""``roofline.k9.restormer`` on the CPU: K9's launches in a 1024 × 1024
Restormer forward counted from the configuration's shapes, and the reader
on made-up traces."""

import json

import pytest

from port_bench import harness, roofline

METRIC = harness.BENCH_DIR / "metrics" / "roofline.k9.restormer.py"


@pytest.fixture(scope="module")
def arch():
    return json.loads((harness.BENCH_DIR / "configs" / "restormer.json")
                      .read_text())["arch"]


def test_one_forward_counts_178_launches_and_their_bound(arch):
    k9 = harness.load_module(METRIC)
    launches = k9.k9_launches(arch, 1024, 1024)
    # 44 blocks x (qkv, v W_eff + x, project_in, project_out) + 2 reductions
    assert len(launches) == 178
    assert sum(o for o, _, _ in launches) == pytest.approx(3.95e12, rel=2e-3)
    assert sum(b for _, b, _ in launches) == pytest.approx(109e9, rel=1e-3)
    assert sum(s for *_, s in launches) == pytest.approx(32.6e-3, rel=2e-3)
    # GDFN's project_out at full resolution: hidden 255 -> 96 and the
    # residual, bound by its bytes
    ops, nbytes, bound = k9._launch(1024 ** 2, 255, 96, True)
    assert ops == 2 * 1024 ** 2 * 255 * 96
    assert nbytes == 4 * (1024 ** 2 * (255 + 2 * 96) + 96 * 255)
    assert bound == pytest.approx(nbytes / roofline.PEAK_BYTES)
    # the latent's project_in, 384 -> 2042 at 128 x 128: bound by its
    # operations at the TF32 peak
    ops, _, bound = k9._launch(128 ** 2, 384, 2042, False)
    assert bound == pytest.approx(ops / roofline.PEAK_TF32_FLOPS)


def ctx(requests, ops, arch):
    return {"trace": {"busy_s": 2.0, "window_s": 10.0,
                      "breakdown": {"device_ops": ops}},
            "work": {"requests": requests, "images": requests},
            "config": {"arch": arch}, "traffic": {"size": 1024}}


def test_the_reader_on_made_up_traces(arch):
    k9 = harness.load_module(METRIC)
    ops = [["(anonymous namespace)::pointwise_gemm_kernel((anonymous "
            "namespace)::Gemm, int)", 2.5],
           ["sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", 0.1],
           ["void (anonymous namespace)::dwconv3x3_f32_kernel<true>(...)",
            0.6]]
    bound = sum(b for *_, b in k9.k9_launches(arch, 1024, 1024))
    assert k9.read(ctx(40, ops, arch)) == pytest.approx(
        100 * 40 * bound / 2.5)
    # fewer than 30 requests, or no record of the kernel (the parent's
    # program): nothing to read
    assert k9.read(ctx(29, ops, arch)) is None
    assert k9.read(ctx(40, ops[1:], arch)) is None
