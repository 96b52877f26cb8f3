"""The job-array driver end to end (replaces ``scripts/run_array_tpu.py``)::

    python -m stofnet_tpu_torch.scripts.run_array [--out DIR] \\
        [--device cpu --smoke]

Three drives of ``cli/array.run`` in one process, on a chirp stand-in
generated under ``DIR`` (default ``build/run_array``; 3 positions, 6 train
and 4 test items a position, 800 IQ samples at rf_scale_factor 10):

1. train mode, ``seeds=2``, 2 epochs at batch 4: two seeds as one vmapped
   program, a checkpoint each;
2. eval mode, ``model_files=`` the two member checkpoints, stacked into
   one program over the test split (``th=Null``);
3. ``th_sweep=[0.01, 0.1, 1.0, 3.0]`` on the first member: one forward a
   batch decoded at the 4 thresholds.

Writes the rows and tables to ``DIR/ARRAY_CLI.md`` and prints it.
``--smoke`` takes 160 IQ samples at rf_scale_factor 4 for a CPU run. The
reference's checkpoints are not in the repository, so the members are
the ones trained in step 1.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from stofnet_tpu_torch.cli.array import run
from stofnet_tpu_torch.cli.main import DEFAULT_CONFIG
from stofnet_tpu_torch.data.synthetic import generate_chirp_dataset
from stofnet_tpu_torch.utils.config import load_config

THRESHOLDS = [0.01, 0.1, 1.0, 3.0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/run_array")
    p.add_argument("--device", default=None)
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    out = Path(args.out)
    sample_num, rf = (160, 4) if args.smoke else (800, 10)
    root = out / "stof_chirp101_dataset"
    if not root.exists():
        generate_chirp_dataset(root, sample_num=sample_num, n_positions=3,
                               n_train_per_pos=6, n_test_per_pos=4)

    def cfg(**over):
        c = load_config(DEFAULT_CONFIG)
        c.update(data_dir=str(root), run_dir=str(out / "runs"),
                 ckpt_dir=str(out / "ckpts"), model="stofnet",
                 rf_scale_factor=rf, max_echoes=8, etol=1600,
                 device=args.device)
        c.update(over)
        return c

    sections = []
    t0 = time.perf_counter()
    tout = run(cfg(seeds=2, epochs=2, batch_size=4, crop_ratio=0.75))
    dt = time.perf_counter() - t0
    sections.append(
        "## train: seeds=2, epochs=2 (one vmapped program)\n\n"
        f"wall {dt:.1f} s | best seed {tout['best_seed']} "
        f"(val loss {tout['best_val_loss']:.4f})\n\n"
        "| seed | val loss | val RMSE | val Jaccard |\n|---|---|---|---|\n"
        + "\n".join(
            f"| {m['seed']} | {m['val_loss']:.4f} | {m['val_rmse']:.2f} "
            f"| {m['val_jaccard']:.1f} |" for m in tout["members"]))

    names = [f"{tout['run_name']}_seed{m['seed']}" for m in tout["members"]]
    t0 = time.perf_counter()
    eout = run(cfg(evaluate=True, batch_size=4, model_files=names, th=None))
    dt = time.perf_counter() - t0
    sections.append(
        f"## eval: model_files={names}\n\nwall {dt:.1f} s\n\n"
        "| member | RMSE | Jaccard % | precision | recall |\n"
        "|---|---|---|---|---|\n"
        + "\n".join(
            f"| {r['member']} | {r['total_distance_mean']:.2f} "
            f"±{r['total_distance_std']:.2f} | {r['total_jaccard']:.1f} "
            f"| {r['precision']:.1f} | {r['recall']:.1f} |"
            for r in eout["rows"]))

    t0 = time.perf_counter()
    sout = run(cfg(evaluate=True, batch_size=4, model_file=names[0],
                   th_sweep=THRESHOLDS))
    dt = time.perf_counter() - t0
    sections.append(
        f"## th_sweep: {THRESHOLDS} (one forward a batch, T decodes)\n\n"
        f"wall {dt:.1f} s\n\n"
        "| member | RMSE | Jaccard % |\n|---|---|---|\n"
        + "\n".join(
            f"| {r['member']} | {r['total_distance_mean']:.2f} "
            f"±{r['total_distance_std']:.2f} | {r['total_jaccard']:.1f} |"
            for r in sout["rows"]))

    body = ("# The job-array driver\n\n"
            f"`cli.array` on {args.device or 'cuda'}: synthetic chirp, "
            f"sample_num={sample_num}, rf_scale_factor={rf}.\n\n"
            + "\n\n".join(sections) + "\n")
    dest = out / "ARRAY_CLI.md"
    dest.write_text(body)
    print(body)
    print(f"wrote {dest}", file=sys.stderr)


if __name__ == "__main__":
    main()
