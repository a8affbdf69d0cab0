"""The traced window's reading on fabricated Chrome-trace events: the busy
union, each kernel's records and time, the copies, the idle gaps named by
what the host was doing, and a window refused where a launch has no
record."""

import pytest

from port_bench import readers, trace

K5 = "void (anonymous namespace)::conv3x3_s8_wgmma_kernel<64, true>(Params)"
K6 = "(anonymous namespace)::convt2x2_s8_kernel(int8_t const*)"


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def window_events():
    return [
        ev("user_annotation", trace.WINDOW_SPAN, 1000, 1000),
        ev("user_annotation", "client.request", 1000, 990),
        ev("cpu_op", "aten::to", 1300, 150),
        # device: two K5 records, one K6, an overlap, a copy each way
        ev("kernel", K5, 1010, 200),
        ev("kernel", K5, 1100, 200),  # overlaps the first
        ev("kernel", K6, 1500, 100),
        ev("kernel", "void at::native::elementwise_kernel<128, 4>", 1600,
           50),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1700, 40),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1745, 20),
        # outside the window: ignored
        ev("kernel", K5, 500, 100),
    ]


def test_summary_reads_the_window():
    s = trace.summarize(window_events(), {"K5": 2, "K6": 1})
    assert s["window_s"] == pytest.approx(1000e-6)
    # union: [1010, 1300] + [1500, 1650] + [1700, 1740] + [1745, 1765]
    assert s["busy_s"] == pytest.approx((290 + 150 + 40 + 20) * 1e-6)
    assert s["records"]["K5"] == 2 and s["records"]["K6"] == 1
    assert s["kernel_s"]["K5"] == pytest.approx(400e-6)
    assert s["kernel_total_s"] == pytest.approx(550e-6)
    assert s["copy_s"]["HtoD"] == pytest.approx(40e-6)
    assert s["copy_s"]["DtoH"] == pytest.approx(20e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 1300-1500 lies inside aten::to (to 1450) and the request span
    assert gaps["client.request / aten::to"] == pytest.approx(200e-6)
    # 1000-1010, 1650-1700 and 1765-2000 inside the request span alone
    assert gaps["client.request"] == pytest.approx((10 + 50 + 235) * 1e-6)
    assert gaps[f"between launches (gaps under {trace.SHORT_GAP_US} us)"] \
        == pytest.approx(5e-6)
    assert s["breakdown"]["device_ops"][0][0].startswith("void (anonymous")
    ctx = {"trace": s}
    assert readers.idle_share(ctx) == pytest.approx(50.0)


def test_a_launch_without_its_record_is_refused():
    events = window_events()
    events.remove(events[4])  # the second K5 record is lost
    with pytest.raises(trace.RecordsMissing, match="K5 1/2"):
        trace.summarize(events, {"K5": 2, "K6": 1})


def test_a_record_without_its_launch_is_refused():
    with pytest.raises(trace.RecordsMissing, match="K6 1/0"):
        trace.summarize(window_events(), {"K5": 2})


def test_kernel_names_are_matched_whole():
    assert trace.kernel_of(K5) == "K5"
    assert trace.kernel_of("double_conv3x3_tf32_kernel<64>(P)") == "K3"
    assert trace.kernel_of("conv3x3_tf32_kernel<64>(P)") == "K2"
    assert trace.kernel_of("my_conv3x3_s8_wgmma_kernel<1>(P)") is None
    assert trace.kernel_of("elementwise_kernel<128>") is None


def test_the_roofline_reader_needs_whole_forwards():
    s = trace.summarize(window_events(), {"K5": 2, "K6": 1})
    ctx = {"trace": s}
    assert readers.kernel_roofline(ctx, "K5", [100e-6, 100e-6]) == \
        pytest.approx(50.0)
    # 2 launches are not a whole number of 3-launch forwards: nothing read
    assert readers.kernel_roofline(ctx, "K5", [1e-6] * 3) is None
    assert readers.kernel_roofline(ctx, "K3", [1e-6]) is None


def test_the_serve_mfu_reads_device_time_not_the_arrival_rate():
    """Requests come at a fixed rate, so ``mfu.serve`` divides by the
    card's busy seconds: the same work in a longer window reads the same,
    the same requests in half the device time read twice as high."""
    from port_bench import harness, roofline

    reader = harness.load_module(harness.BENCH_DIR / "metrics"
                                 / "mfu.serve.py")

    def read(busy_s, window_s):
        return reader.read({
            "trace": {"busy_s": busy_s, "window_s": window_s},
            "work": {"images": 100}, "traffic": {"size": 1024},
            "config": {"depth": 17, "features": 64}})

    assert read(2.0, 4.0) == pytest.approx(read(2.0, 8.0))
    assert read(1.0, 4.0) == pytest.approx(2 * read(2.0, 4.0))
    flops = roofline.dncnn_flops(1, 1024, 1024, 17, 64)
    assert read(2.0, 4.0) == pytest.approx(
        100.0 * flops * 100 / 2.0 / roofline.PEAK_TF32_FLOPS)
    assert read(0.0, 4.0) is None
