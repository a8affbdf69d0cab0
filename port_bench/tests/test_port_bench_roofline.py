"""The operation and byte counts of the yardstick against hand counts for
one layer of each kernel, and the whole models' counts."""

import pytest

from port_bench import roofline


def test_k5_one_layer_by_hand():
    # down1.2 at 2 x 8 x 8: 64 -> 64, s8 in and out, s8 weights
    k, name, ops, nbytes, bound = roofline.int8_unet_launches(2, 8, 8)[1]
    assert (k, name) == ("K5", "down1.2")
    assert ops == 2 * (2 * 8 * 8) * 9 * 64 * 64
    assert nbytes == 2 * 8 * 8 * 64 + 9 * 64 * 64 + 2 * 8 * 8 * 64
    assert bound == max(ops / 1979e12, nbytes / 3.35e12)


def test_k5_output_conv_writes_bf16_and_the_concat_reads_both_halves():
    launches = {n: (k, o, b) for k, n, o, b, _ in
                roofline.int8_unet_launches(1, 16, 16)}
    k, ops, nbytes = launches["upconv1.2"]
    assert k == "K5"
    assert nbytes == 256 * 64 + 9 * 64 * 3 + 256 * 3 * 2
    k, ops, nbytes = launches["upconv1.0"]
    assert ops == 2 * 256 * 9 * 128 * 64
    assert nbytes == 256 * 128 + 9 * 128 * 64 + 256 * 64


def test_k6_one_layer_by_hand():
    # up2 at an input of 1 x 16 x 16: its input is 4 x 4 x 256 -> 8 x 8 x 128
    k, name, ops, nbytes, _ = roofline.int8_unet_launches(1, 16, 16)[6]
    assert (k, name) == ("K6", "up2")
    assert ops == 2 * 16 * 256 * 4 * 128
    assert nbytes == 16 * 256 + 4 * 256 * 128 + 4 * 16 * 128


def test_k2_s8_mode_one_layer_by_hand():
    k, name, ops, nbytes, bound = roofline.int8_unet_launches(1, 4, 4)[0]
    assert (k, name) == ("K2", "down1.0")
    assert ops == 2 * 16 * 9 * 3 * 64
    assert nbytes == 2 * 16 * 3 + 16 * 64 + 2 * 9 * 3 * 64
    assert bound == max(ops / 989e12, nbytes / 3.35e12)


def test_the_int8_program_launches_k2_once_k5_nine_and_k6_twice():
    kinds = [k for k, *_ in roofline.int8_unet_launches(1, 64, 64)]
    assert (kinds.count("K2"), kinds.count("K5"), kinds.count("K6")) == \
        (1, 9, 2)


def test_k3_f32_pair_by_hand():
    ops, nbytes, bound = roofline.f32_pair_launch(1, 4, 4, 64, 64, 64)
    assert ops == 2 * 16 * 9 * (64 * 64 + 64 * 64)
    assert nbytes == 4 * (16 * 64 + 9 * 64 * 64 * 2 + 64 + 64 + 16 * 64)
    assert bound == max(ops / 495e12, nbytes / 3.35e12)


def test_dncnn_runs_eight_k3_launches_a_forward():
    launches = roofline.dncnn_k3_launches(1, 8, 8)
    assert len(launches) == 8
    assert launches[0][0] == 2 * 64 * 9 * (3 * 64 + 64 * 64)


def test_whole_model_counts():
    # 703,232 operations a pixel: about 184 GFLOP for one 512 x 512 image
    assert roofline.unet_flops(1, 512, 512) == 703232 * 512 * 512
    assert roofline.unet_flops(1, 512, 512) == pytest.approx(184.3e9,
                                                             rel=1e-3)
    # 1,112,832 a pixel at depth 17
    assert roofline.dncnn_flops(1, 1024, 1024) == 1112832 * 1024 * 1024
