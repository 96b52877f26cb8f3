"""StofNet's model file against frozen copies of the harness's StofNet
draw and operation count from before configurations named their model:
the same weights, bit for bit, and the same operations a waveform."""

import math

import pytest
import torch

from bench_port import harness
from bench_port.reference import stofnet
from bench_port.tests.conftest import SEED

CONFIGS = ("stofnet-armadillo", "stofnet-nosgb")


def frozen_layers(arch):
    c = arch["num_features"]
    k1, km, kl = arch["kernel_sizes"]
    out = [("conv1", arch["in_channels"], c, k1)]
    scale = arch["semi_global_scale"]
    if scale != 1:
        feat = max(1, scale // 10) * c
        out += [("semi_global_block.contract_conv", c, feat, 5),
                ("semi_global_block.expand_conv", feat, c, 5)]
    out += [(f"conv{i}", c, c, km) for i in range(2, arch["num_blocks"])]
    out.append(("conv_last", c, arch["upsample_factor"], kl))
    return out


def frozen_weights(arch, seed, device):
    shapes = []
    for name, cin, cout, k in frozen_layers(arch):
        bound = 1.0 / math.sqrt(cin * k)
        shapes += [(f"{name}.weight", (cout, cin, k), bound),
                   (f"{name}.bias", (cout,), bound)]
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    state, at = {}, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        state[name] = ((2.0 * u[at:at + n] - 1.0) * bound).reshape(shape)
        at += n
    return state


def frozen_forward_flops(arch, length):
    def conv_flops(positions, cin, cout, k):
        return 2.0 * positions * k * cin * cout

    c = arch["num_features"]
    k1, km, kl = arch["kernel_sizes"]
    nb, r = arch["num_blocks"], arch["upsample_factor"]
    total = conv_flops(length, arch["in_channels"], c, k1)
    scale = arch["semi_global_scale"]
    if scale != 1:
        feat = max(1, scale // 10) * c
        total += conv_flops(length, c, feat, 5)
        total += conv_flops(length // scale, feat, c, 5)
    total += (nb - 2) * conv_flops(length, c, c, km)
    total += conv_flops(length, c, r, kl)
    return total


def config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("seed", [11, SEED])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_model_file_draws_the_frozen_weights(name, seed):
    cfg = config(name)
    assert harness.model_file(cfg).__file__.endswith("reference/stofnet.py")
    got = stofnet.weights(cfg, seed, torch.device("cpu"))
    want = frozen_weights(cfg["architecture"], seed, torch.device("cpu"))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key].view(torch.int32),
                           want[key].view(torch.int32)), key


@pytest.mark.parametrize("length", [800, 8000])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_model_files_operations_are_the_frozen_count(name, length):
    cfg = dict(config(name), length=length)
    assert stofnet.forward_flops(cfg) == frozen_forward_flops(
        cfg["architecture"], length)
