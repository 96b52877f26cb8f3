"""The yardstick: operation and byte counts tied to the bounds that the
kernel phase of ``chip_smoke.py`` prints at B=128, L=8000, and StofNet's
operations a waveform (its model file's ``forward_flops``)."""

import pytest

from bench_port import counts, harness
from bench_port.reference import stofnet


def config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_sgb_bound_at_the_serving_shape():
    least, by = counts.least_s(*counts.sgb_dma_call(128, 8000))
    assert by == "operations"
    assert round(least * 1e3, 4) == 0.3393


def test_conv_stack_bound_at_the_serving_shape():
    least, by = counts.least_s(*counts.conv_stack_call(128, 8000))
    assert by == "operations"
    assert round(least * 1e3, 4) == 0.6547


@pytest.mark.parametrize("name,gflop", [("stofnet-armadillo", 7.72),
                                        ("stofnet-nosgb", 5.07)])
def test_forward_operations_a_waveform(name, gflop):
    total = stofnet.forward_flops(config(name))
    assert round(total / 1e9, 2) == gflop


def test_forward_is_its_kernels_plus_the_plain_convs():
    sgb, _ = counts.sgb_dma_call(1, 8000)
    stack, _ = counts.conv_stack_call(1, 8000)
    conv1 = counts.conv_flops(8000, 1, 64, 9)
    expand = counts.conv_flops(100, 512, 64, 5)
    assert stofnet.forward_flops(config("stofnet-armadillo")) == (
        sgb + stack + conv1 + expand)
    assert stofnet.forward_flops(config("stofnet-nosgb")) == stack + conv1


@pytest.mark.parametrize("name,n", [("stofnet-armadillo", 645764),
                                    ("stofnet-nosgb", 317508)])
def test_parameter_counts(name, n):
    cfg = config(name)
    got = sum(co * ci * k + co for _, ci, co, k in stofnet.layers(
        cfg["architecture"]))
    assert got == cfg["parameters"] == n
