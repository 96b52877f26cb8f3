"""The port's data path and host utilities against the JAX package's, on the
CPU: the stand-in generator's files, the flat-YAML reader and writer,
``Config``/``merge_cli``, ``ChirpDataset`` items, the transforms, the split
and the loader, the native text loader, ``natsorted``, ``zip_extract``,
``find_threshold``, ``coords_to_nested_list``, the logger, the profiler
window and the CPU side of ``DevicePut``.

Generator, transforms, split and shuffle are numpy on both sides, so files,
items and batches are held equal bit for bit; ``find_threshold`` is numpy
on both sides too and is held exactly.
"""

import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from stofnet_tpu import native as jnative
from stofnet_tpu.cli import main as jmain
from stofnet_tpu.data import loader as jloader
from stofnet_tpu.data import synthetic as jsynth
from stofnet_tpu.data import transforms as jtf
from stofnet_tpu.ops.peaks import coords_to_nested_list as jnested
from stofnet_tpu.train.threshold import find_threshold as jfind
from stofnet_tpu.utils import config as jconfig
from stofnet_tpu.utils.natsort import natsorted as jnatsorted
from stofnet_tpu.utils.zip_extract import zip_extract as jzip
from stofnet_tpu_torch import native
from stofnet_tpu_torch.cli import main as pmain
from stofnet_tpu_torch.data import chirp, loader, synthetic, transforms
from stofnet_tpu_torch.ops.peaks import coords_to_nested_list
from stofnet_tpu_torch.train.threshold import find_threshold
from stofnet_tpu_torch.utils import config
from stofnet_tpu_torch.utils.logging import MetricsLogger
from stofnet_tpu_torch.utils.natsort import natsorted
from stofnet_tpu_torch.utils.profiling import StepTraceProfiler, count_params
from stofnet_tpu_torch.utils.zip_extract import zip_extract

REPO = Path(__file__).resolve().parents[1]
GEN = dict(n_positions=3, n_train_per_pos=4, n_test_per_pos=2,
           sample_num=400)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same stand-in written by each package's generator."""
    base = tmp_path_factory.mktemp("gen")
    return (jsynth.generate_chirp_dataset(base / "jax" / "stof_chirp", **GEN),
            synthetic.generate_chirp_dataset(base / "port" / "stof_chirp",
                                             **GEN))


def test_generator_writes_jax_bytes(roots):
    jroot, proot = roots
    jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                    if p.is_file())
    pfiles = sorted(p.relative_to(proot) for p in proot.rglob("*")
                    if p.is_file())
    # per class: truth 3 x 2 files + the csv, train 3 x 4 x 2, test 3 x 2 x 2
    assert jfiles == pfiles and len(pfiles) == 2 * (7 + 24 + 12) + 1
    for rel in pfiles:
        assert (proot / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    text = (proot / "sensor_specs.yaml").read_text()
    assert yaml.safe_load(text) == jsynth.DEFAULT_SPECS
    assert text == yaml.safe_dump(synthetic.DEFAULT_SPECS)


@pytest.mark.parametrize("specs", [
    synthetic.DEFAULT_SPECS,
    {"a": 1e16, "b": -2.5e-7, "c": 3, "d": True, "e": None, "f": "abc",
     "g": "a: b", "h": "3", "i": "null", "j": 0.1},
])
def test_yaml_writer_matches_safe_dump(specs):
    text = config.dump_flat_yaml(specs)
    assert text == yaml.safe_dump(specs)
    assert config.read_flat_yaml(text) == specs


@pytest.mark.parametrize("path", ["stofnet_tpu/cli/config.yaml",
                                  "stofnet_tpu_torch/cli/config.yaml"])
def test_yaml_reader_matches_safe_load(path):
    text = (REPO / path).read_text()
    got, ref = config.read_flat_yaml(text), yaml.safe_load(text)
    assert got == ref
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in ref.items()}


@pytest.mark.parametrize("text,lineno", [
    ("a: 1\nb:\n  c: 2\n", 3),
    ("a: 1\n- 1\n", 2),
    ("a: 1\nlist:\n- b: 1\n", 3),
    ("a: 1\njust text\n", 2),
])
def test_yaml_reader_refuses_nesting(text, lineno):
    with pytest.raises(ValueError, match=f"line {lineno}"):
        config.read_flat_yaml(text)


def test_yaml_reader_comments_and_quotes():
    text = "# head\n\na: 'x # y'  # tail\nb: [0, 1, 2] # c\nc: x#y\n"
    assert config.read_flat_yaml(text) == yaml.safe_load(text)


ARGVS = [
    [],
    ["th=Null", "batch_size=128", "lr=1.0e-3", "sequences=[1,2]"],
    ["model_file=different-armadillo", "evaluate=True", "crop_ratio=0.5",
     "compute_dtype=bfloat16", "etol=", "data_dir=x.zip"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_merge_cli_matches_jax(argv):
    got = config.merge_cli(config.load_config(pmain.DEFAULT_CONFIG), argv)
    ref = jconfig.merge_cli(jconfig.load_config(jmain.DEFAULT_CONFIG), argv)
    assert dict(got) == dict(ref)


def test_interpolation_matches_jax(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("a: 3\nb: ${a}\nc: run_${b}_x\nd: ${missing}\n")
    for argv in ([], ["a=7"], ["b=[1, 2]"], ["a=${c}"]):
        got = config.merge_cli(config.load_config(p), argv)
        ref = jconfig.merge_cli(jconfig.load_config(p), argv)
        assert dict(got) == dict(ref), argv
    cfg = config.load_config(p)
    cfg.a = 5  # a mutation after load survives the merge
    assert config.merge_cli(cfg, [])["b"] == 5


def _cfg(root, **over):
    cfg = jconfig.load_config(jmain.DEFAULT_CONFIG)
    cfg.update(data_dir=str(root), rf_scale_factor=4, **over)
    return cfg


def _same_item(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str):
            assert x == y
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("evaluate", [False, True])
def test_chirp_items_match_jax(roots, evaluate):
    """Train split with crop + noise over two draws of each item; test
    split without transforms."""
    _, proot = roots
    jds, jinfo = jmain.build_dataset(_cfg(proot, evaluate=evaluate))
    pds, pinfo = pmain.build_dataset(config.Config(_cfg(proot,
                                                        evaluate=evaluate)))
    assert isinstance(pds, chirp.ChirpDataset) and len(pds) == len(jds)
    assert pinfo == jinfo
    for _ in range(2 if not evaluate else 1):
        for i in range(len(pds)):
            _same_item(pds[i], jds[i])


def test_transforms_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(800)
    env = np.abs(x)
    cases = [(jtf.NormalizeVol(), transforms.NormalizeVol())]
    for seed in (1, 2):
        cases += [
            (jtf.AddNoise(20, np.random.default_rng(seed)),
             transforms.AddNoise(20, np.random.default_rng(seed))),
            (jtf.CropChannelData(0.6, rng=np.random.default_rng(seed)),
             transforms.CropChannelData(0.6, rng=np.random.default_rng(seed))),
            (jtf.CropChannelData(0.6, resize=True,
                                 rng=np.random.default_rng(seed)),
             transforms.CropChannelData(0.6, resize=True,
                                        rng=np.random.default_rng(seed))),
            (jtf.CropChannelData(None, rng=np.random.default_rng(seed)),
             transforms.CropChannelData(None,
                                        rng=np.random.default_rng(seed))),
        ]
    for j, p in cases:
        assert getattr(p, "ratio", None) == getattr(j, "ratio", None)
        for wave in (x, env):
            for gt in (400.3, 20.0, 790.0):
                for rng_call in (None, 9):
                    rj = rng_call and np.random.default_rng(rng_call)
                    rp = rng_call and np.random.default_rng(rng_call)
                    a, ga = p(wave, gt, rng=rp)
                    b, gb = j(wave, gt, rng=rj)
                    np.testing.assert_array_equal(a, b)
                    assert ga == gb
    comp = [transforms.Compose([transforms.NormalizeVol(),
                                transforms.AddNoise(30)]),
            jtf.Compose([jtf.NormalizeVol(), jtf.AddNoise(30)])]
    outs = [c(x, 3.0, rng=np.random.default_rng(4)) for c in comp]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


def test_split_matches_jax():
    for n, frac, seed in ((24, 0.2, 3008), (1280, 0.2, 3008), (7, 0.5, 1)):
        for a, b in zip(loader.split_dataset(n, frac, seed),
                        jloader.split_dataset(n, frac, seed)):
            np.testing.assert_array_equal(a, b)
    assert loader.default_num_workers() == jloader.default_num_workers()


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(roots, workers):
    """Shuffled batches over two epochs with set_epoch, a second draw of
    every item in the second epoch, and the eval loader's order."""
    _, proot = roots
    cfg = _cfg(proot, evaluate=False)
    jds, _ = jmain.build_dataset(cfg)
    pds, _ = pmain.build_dataset(config.Config(cfg))
    tr, _ = loader.split_dataset(len(pds), 0.2, 3008)
    for shuffle in (True, False):
        jl = jloader.DataLoader(jds, tr, batch_size=4, shuffle=shuffle,
                                drop_last=True, seed=3008,
                                num_workers=workers)
        pl = loader.DataLoader(pds, tr, batch_size=4, shuffle=shuffle,
                               drop_last=True, seed=3008,
                               num_workers=workers)
        assert len(pl) == len(jl) == 5
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            pairs = list(zip(pl, jl))
            assert len(pairs) == 5
            for pb, jb in pairs:
                _same_item(pb, jb)


def test_pipeline_batches_on_the_cpu(roots):
    """DevicePut on the CPU hands back tensors of the host arrays, and
    pipeline_batches pairs each host batch with its own."""
    _, proot = roots
    pds, _ = pmain.build_dataset(config.Config(_cfg(proot, evaluate=True)))
    dl = loader.DataLoader(pds, batch_size=4, drop_last=True)
    put = loader.DevicePut("cpu")
    pairs = list(loader.pipeline_batches(pmain._host_batches(dl, 4), put))
    assert len(pairs) == len(dl) == 3
    for host, dev in pairs:
        assert len(host) == len(dev) == 3
        for h, d in zip(host, dev):
            assert d.device.type == "cpu"
            np.testing.assert_array_equal(d.numpy(), h)
    assert list(loader.pipeline_batches(iter([]), put)) == []


FILES = {
    "ws.txt": "1.5 2.5\n3.5 -4e-3\n",
    "comma.csv": "0,1.25\n1,2.5\n2,3.75\n",
    "comment.txt": "# head\n1.0  # one\n\n2.0\n3.0\n",
    "bom.txt": "﻿1.0\n2.0\n",
    "one_row.txt": "1 2 3\n",
    "nan.txt": "nan\ninf\n-1\n",
}
CORRUPT = {"corrupt.txt": "1.0\n2.0 x3\n", "underscore.txt": "1_0\n"}


@pytest.mark.parametrize("name", sorted(FILES) + sorted(CORRUPT))
def test_loadtxt_matches_jax(tmp_path, name):
    """Each parser of the port (the C++ one where it builds, and the
    python one) gives the arrays of the JAX package's same parser, and
    every parser refuses the same corrupt files with the same error. (The
    C++ parser takes its column count from the first line holding a digit,
    sign or dot, so a file that opens with 'nan' reads in another shape
    than the python one: the JAX package's quirk, kept.)"""
    p = tmp_path / name
    p.write_text({**FILES, **CORRUPT}[name], encoding="utf-8")
    ours = [native.loadtxt, native._py_loadtxt]
    theirs = [jnative.loadtxt, jnative._py_loadtxt]
    if name in CORRUPT:
        msgs = set()
        for f in ours + theirs:
            with pytest.raises(ValueError) as e:
                f(p)
            msgs.add(str(e.value))
        assert len(msgs) == 1 and "line" in msgs.pop()
        return
    for f, g in zip(ours, theirs):
        got, ref = f(p), g(p)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_native_builds_outside_the_package():
    assert native.available() == jnative.available()
    if native.available():
        assert native._LIB.parent == REPO / "build" / "native"
        assert not list((REPO / "stofnet_tpu_torch").rglob("*.so"))


def test_natsorted_matches_jax():
    items = ["meas_10", "meas_2", "Meas_3", "a1b10", "a1b9", "x", "meas_1_10",
             "meas_1_9", Path("seq_11"), Path("seq_3")]
    items = [str(i) for i in items]
    assert natsorted(items) == jnatsorted(items)


@pytest.mark.parametrize("layout", ["rooted", "flat"])
def test_zip_extract_matches_jax(tmp_path, layout):
    results = []
    for side, fn in (("jax", jzip), ("port", zip_extract)):
        d = tmp_path / side
        d.mkdir()
        zp = d / "stof_chirp101_dataset.zip"
        with zipfile.ZipFile(zp, "w") as zf:
            prefix = "inner_dir/" if layout == "rooted" else ""
            zf.writestr(prefix + "a.txt", "1\n")
            zf.writestr(prefix + "sub/b.txt", "2\n")
        out = fn(zp)
        assert fn(zp) == out  # idempotent
        results.append((out.relative_to(d),
                        sorted(str(p.relative_to(out))
                               for p in out.rglob("*"))))
    assert results[0] == results[1]


def test_find_threshold_matches_jax():
    rng = np.random.default_rng(3)
    for norm_opt in (False, True):
        pred = rng.standard_normal((3, 1, 640)).astype(np.float32)
        pred[0, 0, 100:110] += 4
        truth = np.zeros((3, 1, 640), np.float32)
        truth[0, 0, 104] = 1
        truth[2, 0, 10] = 1
        for t in (truth, np.zeros_like(truth)):
            got = find_threshold(pred, t, norm_opt=norm_opt)
            ref = jfind(pred, t, norm_opt=norm_opt)
            assert got == ref or (np.isinf(got) and np.isinf(ref))


def test_coords_to_nested_list_matches_jax():
    c = np.array([[3.5, 0, 7.25], [0, 0, 0]], np.float32)
    c3 = np.stack([c, c[::-1]])
    for x in (c, c3):
        assert coords_to_nested_list(x) == jnested(x)
        assert coords_to_nested_list(torch.from_numpy(x)) == jnested(x)


def test_logger_writes_jsonl_and_summary(tmp_path):
    log = MetricsLogger(tmp_path, "quiet-sonar-1234",
                        config={"a": np.float32(1.5), "p": Path("x")})
    log.log({"event": "train", "loss": np.float64(0.25),
             "v": torch.tensor(2.0)})
    log.set_summary(val=np.array([1, 2]))
    log.finish()
    rows = [json.loads(line) for line in
            (tmp_path / "quiet-sonar-1234.jsonl").read_text().splitlines()]
    assert rows[0]["event"] == "config" and rows[0]["a"] == 1.5
    assert rows[1]["loss"] == 0.25 and rows[1]["v"] == 2.0
    summary = json.loads(
        (tmp_path / "quiet-sonar-1234_summary.json").read_text())
    assert summary == {"val": [1, 2]}


def test_profiler_traces_steps_2_to_n_plus_1(tmp_path):
    prof = StepTraceProfiler(str(tmp_path / "trace"), steps=2)
    marks = []
    for i in range(5):
        with torch.profiler.record_function(f"step_{i + 1}"):
            torch.ones(4).sum()
        prof.step()
        marks.append(prof.path)
    prof.close()
    assert marks[:2] == [None, None] and marks[2] is not None
    names = {e.get("name") for e in
             json.loads(marks[2].read_text())["traceEvents"]}
    assert {"step_2", "step_3"} <= names
    assert not {"step_1", "step_4", "step_5"} & names
    assert count_params({"a": torch.zeros(3, 4), "b": torch.zeros(5)}) == 17
