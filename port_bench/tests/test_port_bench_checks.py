"""The comparison that decides ``correct``, on the CPU at small sizes: each
plain reference against the port's plain route, each control failing the
configuration's limit, and whole runs with the timed path broken
underneath coming out not correct."""

import numpy as np
import pytest
import torch

from port_bench import compare, gen, harness

SIZE = 32
SMALL = {
    "denoise_unet.bulk512": {"size": SIZE, "batch": 2, "pool": 2,
                             "keep_share": 1.0, "warm_batches": 1},
    "dncnn.requests1024": {"size": SIZE, "pool": 3, "rate_per_s": 30,
                           "workers": 2, "warm_requests": 1},
}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


@pytest.fixture(scope="module")
def servers(bench):
    """The port's server for each configuration, on the CPU."""
    out = {}
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"], 0, "cpu")
        out[cell.config["name"]] = (cell, cell.make_server())
    return out


def inputs(n=2, seed=2 ** 31 + 11):
    return gen.noisy_u8(seed, n, SIZE, 0.1, "cpu")


def test_the_int8_reference_matches_the_ports_plain_route(servers):
    cell, server = servers["denoise_unet"]
    assert server.ladder("denoise") == "int8-s8skip"
    u8 = inputs()
    apply = server._apply("denoise", "plain")
    with torch.inference_mode():
        got = server._to_u8("denoise", apply(gen.served_domain(u8,
                                                              "[-1,1]")))
    ref = cell.reference().Reference(cell.config, "cpu")(u8)
    tally = compare.ImageTally()
    tally.add(got, ref)
    # equal as a rule; conv 0 sums its bf16 products in float32 in the
    # order the CPU's convolution picks, which has differed between runs
    # of one test (worst image 0.20 counts at 32 x 32), and every later
    # s8 step follows from it
    assert tally.numbers()["worst_image_mad"] < 0.5 * \
        cell.config["limits"]["worst_image_mad"]["max"], tally.numbers()


def test_the_f32_reference_matches_the_ports_plain_route(servers):
    cell, server = servers["dncnn"]
    u8 = inputs()
    got = torch.as_tensor(np.stack([
        server.denoise_image(im, "dncnn", plain=True) for im in u8.numpy()]))
    tally = compare.ImageTally()
    tally.add(got, cell.reference().Reference(cell.config, "cpu")(u8))
    numbers = tally.numbers()
    # BatchNorm folded on the port's side, apart on the reference's: a
    # value may truncate to the neighbouring count
    assert numbers["max_abs_counts"] <= 1
    assert numbers["worst_image_mad"] < 0.1 * \
        cell.config["limits"]["worst_image_mad"]["max"]


def sound(workload, hook=None, seed=2 ** 31 + 3):
    return harness.run(workload, seed, 0.3, False, 0.0, device="cpu",
                       overrides=SMALL[workload], hook=hook)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails_the_limit(workload):
    """The reference in the precision below the stated one (int4 for int8,
    TF32 for float32) in the timed program's place, through the whole run
    and the harness's own comparison: not correct."""
    r = sound(workload, harness.control)
    assert r["failed"] == 0 and r["attempted"] > 0
    assert not r["correct"]
    assert not r["_checks"]["worst_image_mad"]["ok"]
    assert r["_checks"]["images_compared"]["ok"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_reference_in_the_programs_place_is_correct(workload):
    """The same substitution at the stated precision: correct, so what
    fails the control is its precision, not the substitution."""
    def hook(state):
        cell = state.cell
        state.substitute(cell.reference().Reference(cell.config,
                                                    cell.device))
    r = sound(workload, hook)
    assert r["correct"], r["checks"]
    assert r["checks"]["worst_image_mad"]["value"] == 0.0


def break_with(fault):
    def hook(state):
        state.call = fault(state.call)
    return hook


def unchanged(call):
    """The step returns its input (its state) unchanged."""
    def broken(x):
        if isinstance(x, np.ndarray):  # a request: the upload itself
            return x.copy()
        x01 = x * 0.5 + 0.5
        return (torch.clamp(x01, 0, 1) * 255).to(torch.uint8).numpy()
    return broken


def half_batch(call):
    """Half of the batch left out: its answers are the mean of the rest."""
    def broken(xs):
        y = call(xs[: xs.shape[0] // 2])
        mean = y.astype(np.float32).mean(axis=0, keepdims=True)
        rest = np.repeat(mean.astype(np.uint8), xs.shape[0] - y.shape[0], 0)
        return np.concatenate([y, rest])
    return broken


def one_answer_altered(call):
    """One answer altered where it is produced: 16 counts on one image."""
    done = [0]

    def broken(x):
        y = np.array(call(x))
        if done[0] == 1:  # a request's image, or a batch's first image
            one = y if y.ndim == 3 else y[0]
            one[...] = np.clip(one.astype(np.int16) + 16, 0, 255)
        done[0] += 1
        return y
    return broken


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload):
    r = sound(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("workload,fault", [
    ("denoise_unet.bulk512", unchanged),
    ("denoise_unet.bulk512", half_batch),
    ("denoise_unet.bulk512", one_answer_altered),
    ("dncnn.requests1024", unchanged),
    ("dncnn.requests1024", one_answer_altered),
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    r = sound(workload, break_with(fault))
    assert not r["correct"]
    assert not r["_checks"]["worst_image_mad"]["ok"]
