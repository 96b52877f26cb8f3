"""The plain reference against the port's plain route at a tiny size,
its judgement of served positions, and its independence of the
program."""

import ast

import numpy as np
import pytest
import torch

from bench_port import check, harness, inputs
from bench_port.reference import common
from bench_port.reference import stofnet as ref

CONFIGS = ("stofnet-armadillo", "stofnet-nosgb")


def config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_ports_module_in_f32(name):
    from stofnet_tpu_torch.models.stofnet import StofNet

    cfg = config(name)
    state = ref.weights(cfg, 5, torch.device("cpu"))
    x = inputs.frames(3, 800, inputs.rng(5, "frames"))
    module = StofNet(device="cpu", **cfg["overrides"])
    module.load_state_dict(state)
    with torch.no_grad():
        want = module(torch.from_numpy(x))[:, 0]
    got = ref.heatmap(state, torch.from_numpy(x), cfg)
    assert got.shape == want.shape == (3, 800 * ref.upsample_factor(cfg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_judges_the_ports_bf16_route_correct(name):
    from stofnet_tpu_torch.serve import make_pipeline

    cfg = config(name)
    state = ref.weights(cfg, 6, torch.device("cpu"))
    x = inputs.frames(8, 800, inputs.rng(6, "frames"))
    pipe = make_pipeline(state, dict(cfg["overrides"]), device="cpu",
                         model_name=cfg["model"], dtype=torch.bfloat16,
                         **cfg["decode"])
    assert pipe.route(800) == "fused"
    gaps = check.gaps(cfg, ref, state, [(x, pipe(x).numpy())],
                      torch.device("cpu"))
    assert gaps.shape == (8,)
    assert check.passed(check.checks(cfg, gaps, 0))


def test_served_gaps():
    heat = torch.tensor([[0.0, 1.0, 3.0, 2.0, -1.0, 0.5, 0.0, 0.2]])
    sd = float(heat.std())

    def gap(*coords, up=2):
        c = torch.zeros(1, 4)
        c[0, :len(coords)] = torch.tensor(coords)
        return float(common.served_gaps(heat, c, up)[0])

    assert gap(1.0) == 0.0  # position 2, the best
    assert gap(1.5) == pytest.approx(1.0 / sd)  # position 3
    assert gap(1.0, 2.0) == pytest.approx(4.0 / sd)  # the worst served
    assert gap() == pytest.approx(3.0 / sd)  # nothing served: position 0
    assert gap(4.0) == float("inf")  # position 8, outside the row
    assert gap(float("nan")) == float("inf")


def test_control_reads_the_argmax_of_its_own_heatmap():
    heat = torch.tensor([[0.0, 1.0, 3.0, 2.0], [5.0, 1.0, 0.0, 0.0]])
    got = common.argmax_coords(heat, 2, 3)
    assert got.tolist() == [[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
    assert common.served_gaps(heat, got, 2).tolist() == [0.0, 0.0]


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.tensor([448.0, 1.0, 1.0625, -3.3])
    got = common.fp8(t)
    assert got[0] == 448.0 and got[1] == 1.0 and got[2] == 1.0
    assert got[3] == -3.25


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "stofnet_tpu_torch", "stofnet_tpu", "jax", "jaxlib",
                    "flax"), (path.name, n)
