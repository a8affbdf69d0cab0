"""Each traffic mix's loop on a fake program: the work it counts, the
metrics it reports, the answers it keeps, and the inputs it draws from the
seed."""

import numpy as np
import pytest
import torch

from port_bench import gen, harness

SMALL = {
    "denoise_unet.bulk512": {"size": 16, "batch": 4, "pool": 3,
                             "keep_share": 0.5, "warm_batches": 2},
    "dncnn.requests1024": {"size": 16, "pool": 5, "rate_per_s": 40,
                           "workers": 3, "warm_requests": 1},
}


class FakeServer:
    """Serves each input as its own uint8 view, counting calls."""

    def __init__(self, cell):
        self.cell = cell
        self.batches = 0
        self.requests = 0

    def _batched_dispatch(self, family):
        def dispatch(xs):
            self.batches += 1
            x01 = xs * 0.5 + 0.5 if self.cell.config["domain"] == "[-1,1]" \
                else xs
            return (torch.clamp(x01, 0, 1) * 255).round().to(torch.uint8)
        return dispatch

    def ladder(self, family):
        return self.cell.config["rung"]

    def warmup(self, sizes, models):
        pass

    def denoise_image(self, image, family):
        self.requests += 1
        return image.copy()


def fake_cell(workload, seed=2 ** 31 + 7):
    cell = harness.Cell(harness.load_benchmark(), workload, seed, "cpu",
                        SMALL[workload])
    server = FakeServer(cell)
    cell.make_server = lambda: server
    return cell, server


def identity(u8):
    return u8.clone()


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_loop_runs_on_a_fake_program(workload):
    cell, server = fake_cell(workload)
    state = cell.loop().State(cell)
    work = state.window(0.2)
    assert work["failed"] == 0 and work["images"] > 0
    assert work["attempted"] == work["images"]
    assert work["metrics"]["images_per_s"] == pytest.approx(
        work["images"] / work["wall_s"])
    state.release()
    numbers = state.compare(identity)
    assert numbers["worst_image_mad"] == 0.0
    assert numbers["images_compared"] > 0
    if workload == "dncnn.requests1024":
        # every answer of the window is compared
        assert numbers["images_compared"] == work["requests"]
        assert work["metrics"]["latency_p50_ms"] <= \
            work["metrics"]["latency_p95_ms"]
        assert server.requests == work["requests"] + 3  # + the warm-up
    else:
        b = cell.traffic["batch"]
        assert work["images"] == b * (server.batches - 2)
        assert numbers["images_compared"] % b == 0


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_substitute_takes_the_programs_place(workload):
    """What ``substitute`` is handed answers every call of the window, on
    the uint8 images of each call's input; the program is not called."""
    cell, server = fake_cell(workload)
    state = cell.loop().State(cell)
    before = (server.batches, server.requests)
    seen = []

    def fn(u8):
        seen.append(u8.shape[0])
        return 255 - u8
    state.substitute(fn)
    work = state.window(0.2)
    assert work["failed"] == 0 and work["images"] == sum(seen) > 0
    assert (server.batches, server.requests) == before
    numbers = state.compare(lambda u8: 255 - u8)
    assert numbers["worst_image_mad"] == 0.0
    assert numbers["images_compared"] > 0


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_failing_call_is_counted(workload):
    cell, _ = fake_cell(workload)
    state = cell.loop().State(cell)

    def broken(_x):
        raise RuntimeError("kernel error")
    state.call = broken
    work = state.window(0.05)
    assert work["failed"] == work["attempted"] > 0
    assert cell.failures and "kernel error" in cell.failures[0]


def test_the_same_seed_draws_the_same_inputs():
    a = gen.noisy_u8(2 ** 31 + 5, 3, 16, 0.1, "cpu")
    b = gen.noisy_u8(2 ** 31 + 5, 3, 16, 0.1, "cpu")
    c = gen.noisy_u8(2 ** 31 + 6, 3, 16, 0.1, "cpu")
    assert a.dtype == torch.uint8 and tuple(a.shape) == (3, 16, 16, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_the_serving_domain_is_the_servers():
    u8 = torch.arange(256, dtype=torch.uint8).view(1, 16, 16, 1).expand(
        1, 16, 16, 3).contiguous()
    x = u8.numpy().astype(np.float32) / 255.0
    assert np.array_equal(gen.served_domain(u8, "[0,1]").numpy(), x)
    assert np.array_equal(gen.served_domain(u8, "[-1,1]").numpy(),
                          (x - 0.5) / 0.5)
