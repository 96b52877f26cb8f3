"""Whole runs of each cell on the CPU at tiny sizes: the last line's
keys, cells and metrics found by name (also ones added as files to a
copy), the run's refusals, the import check, and faults planted under
the timed path coming out as not correct."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.tests.conftest import ROOT, SEED, SHRINK

CELLS = ("armadillo.batch128", "nosgb.batch128")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=False, **kw):
    return harness.run_cell(cell, SEED, 1.0, trace, t0=time.perf_counter(),
                            device="cpu", shrink=SHRINK, **kw)


def test_benchmark_names_a_file_for_everything(bench):
    for w in bench["workloads"]:
        entry, cell, cfg = harness.cell_files(w["name"], bench)
        assert cfg["name"] == cell["config"]
        assert all(callable(getattr(harness.model_file(cfg), f))
                   for f in harness.MODEL_FUNCTIONS)
        drv = harness.driver(cell["driver"])
        assert all(callable(getattr(drv, f))
                   for f in ("setup", "measure", "samples"))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_set_up_and_more(bench, cell):
    """set-up, another end-to-end metric, a per-layer one moving it."""
    e2e = [m["name"] for m in harness.metrics_for(bench, cell, False)]
    per = harness.metrics_for(bench, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert per and all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_of_each_cell(bench, cell, trace):
    out = run(cell, trace)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {m["name"] for m in harness.metrics_for(bench, cell, trace)}
    assert set(out["metrics"]) <= names
    if not trace:  # the end-to-end metrics are host clock: all there
        assert set(out["metrics"]) == names
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["checks"]["missing"]["value"] == 0


# a second architecture's model file, as a later configuration adds it:
# the registry's ESPCN-1D in plain PyTorch, with weights of its own
ESPCN = textwrap.dedent('''
    """ESPCN-1D: tanh(conv1 k5), tanh(conv2 k3), conv3 k3, sample
    shuffle, sigmoid; SAME convs, f32 without TF32."""

    import math

    import torch
    import torch.nn.functional as F

    from bench_port.reference.common import no_tf32

    LAYERS = (("conv1", 1, 64, 5), ("conv2", 64, 32, 3))


    def layers(cfg):
        return LAYERS + (("conv3", 32, upsample_factor(cfg), 3),)


    def weights(cfg, seed, device):
        shapes = []
        for name, cin, cout, k in layers(cfg):
            bound = 1.0 / math.sqrt(cin * k)
            shapes += [(name + ".weight", (cout, cin, k), bound),
                       (name + ".bias", (cout,), bound)]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        u = torch.rand(sum(math.prod(s) for _, s, _ in shapes),
                       generator=gen, device=device)
        state, at = {}, 0
        for name, shape, bound in shapes:
            n = math.prod(shape)
            state[name] = ((2 * u[at:at + n] - 1) * bound).reshape(shape)
            at += n
        return state


    def _conv(state, h, name, quant):
        w, b = state[name + ".weight"], state[name + ".bias"]
        if quant is not None:
            h, w = quant(h), quant(w)
        k = w.shape[-1]
        return F.conv1d(F.pad(h, ((k - 1) // 2, k // 2)), w) + b[:, None]


    def heatmap(state, x, cfg, quant=None):
        with no_tf32(), torch.no_grad():
            h = torch.tanh(_conv(state, x.float(), "conv1", quant))
            h = torch.tanh(_conv(state, h, "conv2", quant))
            h = torch.sigmoid(_conv(state, h, "conv3", quant))
            return h.transpose(1, 2).reshape(h.shape[0], -1)


    def forward_flops(cfg):
        return sum(2.0 * cfg["length"] * k * cin * cout
                   for _, cin, cout, k in layers(cfg))


    def upsample_factor(cfg):
        return int(cfg["architecture"]["upsample_factor"])
    ''')
ESPCN_CONFIG = {
    "name": "espcn-chirp", "model": "espcn",
    "source": "https://arxiv.org/abs/1609.05158",
    "architecture": {"upsample_factor": 4},
    "overrides": {"upsample_factor": 4}, "length": 8000,
    "dtype": "float32",
    "decode": {"window_size": 20, "threshold": None, "max_echoes": 64},
    "route": "module", "launches_per_batch": {}, "reduced": [],
    "limits": {"coord_gap_mean": 0.010, "coord_gap_max": 0.3}}


def tree_files(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("model", ["stofnet", "espcn"])
def test_a_cell_and_a_metric_added_as_files(tmp_path, model):
    """A cell, a metric and (``espcn``) a configuration of another
    architecture with its model file, each added as a new file to a copy
    of the benchmark, whose files stay as they are."""
    copy = tmp_path / "bench_port"
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_json(copy / "workloads" / "nosgb.batch128.json")
    cell["params"]["batch"] = 2
    name, added = "nosgb.batch2", {}
    if model == "espcn":
        name, cell["config"] = "espcn.batch2", ESPCN_CONFIG["name"]
        added["reference/espcn.py"] = ESPCN
        added["configs/espcn-chirp.json"] = json.dumps(ESPCN_CONFIG)
        bench["configs"].append(dict(
            name="espcn-chirp", source=ESPCN_CONFIG["source"],
            file="bench_port/configs/espcn-chirp.json", reduced=[],
            why="test"))
    added[f"workloads/{name}.json"] = json.dumps(cell)
    added["metrics/host_leg.batches.py"] = textwrap.dedent('''
        def read(rec):
            return float(rec.window["batches"])
        ''')
    for path, text in added.items():
        (copy / path).write_text(text)
    bench["workloads"].append(dict(name=name, config=cell["config"],
                                   traffic="batch128", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="host_leg.batches", unit="batches", better="higher",
        source="program_counter", layer="host leg", moves="waveforms_per_s",
        workloads=[name]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tree, copied = tree_files(harness.HERE), tree_files(copy)
    assert {str(p) for p in set(copied) - set(tree)} == set(added)
    assert all(copied[p] == tree[p] for p in tree)

    def run_copy():
        return harness.run_cell(name, SEED, 1.0, True,
                                t0=time.perf_counter(), device="cpu",
                                shrink={"length": 800, "pool": 2,
                                        "warmup": 1},
                                root=tmp_path, here=copy)

    out = run_copy()
    assert out["correct"] is True
    assert out["metrics"]["host_leg.batches"]["value"] == out["attempted"]
    if model == "espcn":
        # the reference's conv3 bias raised by 1 on phase 0 of the shuffle,
        # which moves its best position off the program's (on this seed
        # the program's best lies in another phase: the weights decide it)
        (copy / "reference" / "espcn.py").write_text(ESPCN.replace(
            '"conv3", quant)', '"conv3", quant) + torch.eye(4, 1)'))
        out = run_copy()
        gap = out["checks"]["coord_gap_mean"]
        assert out["correct"] is False and gap["value"] > gap["limit"]


@pytest.mark.parametrize("fault", ["no model", "no model file",
                                   "a regression family",
                                   "a model file lacking heatmap"])
def test_a_configuration_without_its_model_is_refused(tmp_path, fault):
    copy = tmp_path / "bench_port"
    shutil.copytree(harness.HERE, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    path = copy / "configs" / "stofnet-nosgb.json"
    cfg = harness.load_json(path)
    if fault == "no model":
        del cfg["model"]
    elif fault == "no model file":
        cfg["model"] = "edsr"
    elif fault == "a regression family":
        # a family that answers with positions has no heatmap to judge by
        cfg["model"] = "zonzini"
        (copy / "reference" / "zonzini.py").write_text(
            "def weights(cfg, seed, device):\n    return {}\n\n\n"
            "def forward_flops(cfg):\n    return 1.0\n\n\n"
            "def upsample_factor(cfg):\n    return 1\n\n\n"
            "def positions(state, x, cfg):\n    return x\n")
    else:
        cfg["model"] = "half"
        (copy / "reference" / "half.py").write_text(
            "def weights(cfg, seed, device):\n    return {}\n")
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.Refused, match=(
            "names no model" if fault == "no model" else
            "no file" if fault == "no model file" else
            r"lacks \['heatmap'\]" if fault == "a regression family" else
            "lacks")):
        harness.run_cell("nosgb.batch128", SEED, 1.0, False,
                         t0=time.perf_counter(), device="cpu",
                         shrink=SHRINK, root=tmp_path, here=copy)


def test_a_traced_run_stops_at_the_span_guard(monkeypatch):
    """A device op of ``pipe`` in none of the program's call parts ends a
    traced run with no result; an untraced run never reads the guard."""
    from bench_port import spans
    from bench_port.trace import Op

    stray = Op("fill_kernel", "kernel", 0.0, 1e-6, 0.0)
    monkeypatch.setattr(spans, "uncovered",
                        lambda trace, outer: [stray] if trace else None)
    assert run("nosgb.batch128")["correct"] is True
    with pytest.raises(RuntimeError, match="span guard: 1 device ops"):
        run("nosgb.batch128", trace=True)


@pytest.mark.parametrize("seed", [3, SEED])
def test_the_sample_is_the_seeds_whatever_the_windows_length(seed):
    """The same pool batches, with the answers a deterministic program
    gives them, at any window length; each at a call that sent it."""
    from types import SimpleNamespace

    from bench_port import inputs

    drv = harness.driver("batch")
    pool = 16

    def sample(n):
        run = SimpleNamespace(
            frames=np.arange(pool, dtype=np.float32)[:, None],
            outs=[np.float32([i % pool, i]) for i in range(n)],
            ctx=SimpleNamespace(params={"sample_batches": 8}))
        got, missing = drv.samples(run, inputs.rng(seed, "sample"))
        assert missing == 0 and len(got) == min(n, 8)
        assert all(f[0] == o[0] and o[1] < n for f, o in got)
        return sorted(int(o[0]) for _, o in got)

    picked = sample(10_000)
    assert len(set(picked)) == 8
    assert all(sample(n) == picked for n in (16, 999, 12_345, 31_868))
    assert len(set(sample(5))) == 5  # a window shorter than the pool


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = textwrap.dedent(f'''
        import sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        torch.set_num_threads(2)
        from bench_port import harness
        harness.run_cell("armadillo.batch128", {SEED}, 0.5, False,
                         t0=time.perf_counter(), device="cpu",
                         shrink={SHRINK!r}, log=lambda m: None)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
        ''')
    done = _python(code, ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    top = set(eval(done.stdout.strip().splitlines()[-1]))
    assert "stofnet_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "stofnet_tpu"}
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import bench_port.reference.stofnet, bench_port.check
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
        ''')
    done = _python(code, ROOT)
    top = set(eval(done.stdout.strip().splitlines()[-1]))
    assert not top & {"stofnet_tpu_torch", "jax", "flax", "stofnet_tpu"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "armadillo.batch128", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "cuda" in done.stderr.lower()


def test_the_benchmarks_files_alone_give_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = textwrap.dedent(f'''
        import sys, time, json
        sys.path.insert(0, {str(tmp_path)!r})
        from bench_port import harness
        out = harness.run_cell("armadillo.batch128", {SEED}, 0.5, False,
                               t0=time.perf_counter(), device="cpu",
                               shrink={SHRINK!r})
        print(json.dumps(out))
        ''')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = _python(code, tmp_path, env)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "stofnet_tpu_torch" in done.stderr


def half_left_out(coords):
    coords = coords.clone()
    coords[coords.shape[0] // 2:] = 0.0
    return coords


def answer_moved(coords):
    return torch.where(coords != 0, coords + 7.25, coords)


def row_moved(coords):
    """One row's answer moved, the rest of the batch served right."""
    coords = coords.clone()
    coords[1] = answer_moved(coords[1])
    return coords


def break_pipeline(monkeypatch, fault):
    """Every ``make_pipeline`` serves ``fault`` of its answers."""
    from stofnet_tpu_torch import serve

    real = serve.make_pipeline

    def broken(*args, **kwargs):
        pipe = real(*args, **kwargs)

        def call(x):
            return fault(pipe(x))

        call.route = pipe.route
        return call

    monkeypatch.setattr(serve, "make_pipeline", broken)


@pytest.mark.parametrize("fault, caught_by", [
    (half_left_out, "coord_gap_mean"), (answer_moved, "coord_gap_mean"),
    (row_moved, "coord_gap_max")])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, cell,
                                                     fault, caught_by):
    break_pipeline(monkeypatch, fault)
    out = run(cell)
    assert out["correct"] is False
    assert out["checks"][caught_by]["value"] > \
        out["checks"][caught_by]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_one_wrong_row_among_many_is_caught_by_the_widest(cell):
    """1,024 sampled rows, as a batch cell's check holds, one of them at
    the least gap that a row's moved answer read on the card (0.465):
    the mean stays under its limit, the widest gap fails the run."""
    from bench_port import check

    _, _, cfg = harness.cell_files(cell, harness.load_json(
        ROOT / "BENCHMARK.json"))
    gaps = np.full(1024, 0.002)
    gaps[517] = 0.465
    out = check.checks(cfg, gaps, 0)
    assert out["coord_gap_mean"]["value"] <= out["coord_gap_mean"]["limit"]
    assert out["coord_gap_max"]["value"] > out["coord_gap_max"]["limit"]
    assert not check.passed(out)
    assert check.passed(check.checks(cfg, np.full(1024, 0.002), 0))


@pytest.mark.parametrize("cell", ["armadillo.batch128", "nosgb.batch128"])
def test_the_control_is_not_correct(cell):
    from bench_port import control

    cfg = harness.load_json(harness.HERE / "configs" / (
        harness.load_json(harness.HERE / "workloads" / f"{cell}.json")[
            "config"] + ".json"))
    rows = control.main(["--workload", cell, "--seeds", "1", "2",
                         "--controls"], device="cpu",
                        shrink={"length": 800, "batch": 16, "pool": 2,
                                "sample_batches": 2})
    mean, widest = (cfg["limits"][k] for k in ("coord_gap_mean",
                                                "coord_gap_max"))
    for row in rows:
        assert row["program"]["mean"] <= mean < row["fp8"]["mean"]
        assert row["program"]["max"] <= widest
        assert min(row["half_left_out"]["mean"],
                   row["answer_moved"]["mean"]) > mean
        assert row["row_moved"]["max"] > widest


@pytest.mark.cuda
def test_each_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        out = harness.run_cell(cell, SEED, 2.0, False,
                               t0=time.perf_counter())
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
