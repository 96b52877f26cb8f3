"""The chirp sweep table with rows trained here (replaces
``scripts/run_chirp_sweep.py``)::

    python -m stofnet_tpu_torch.scripts.run_chirp_sweep [epochs] \\
        [--out DIR] [--device cpu --smoke]

The reference's checkpoints (``cli/sweep.SWEEPS["chirp"]``) are not in
the repository, so their rows run from random weights and carry the
dagger. Rows with meaning come from StofNet and EDSR trained here, on the
train split of a chirp stand-in generated under ``DIR`` (default
``build/chirp_sweep``; 4 positions, 40 train and 10 test items a
position, 800 IQ samples at rf_scale_factor 10: L=8000, the protocol's
length), with the StofNet checkpoint also through the int8 route. The
sweep runs the chirp protocol (``SWEEP_OVERRIDES["chirp"]``: batch 1,
rf_scale_factor 10, etol 1) on the test split and writes
``DIR/runs_sweep/metrics_table.{md,tex}``. ``--smoke`` takes a 2-position
stand-in of 160 IQ samples, batch 2 and 1 epoch, for a CPU run.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from stofnet_tpu_torch.cli.main import DEFAULT_CONFIG, run
from stofnet_tpu_torch.cli.sweep import (
    SWEEP_OVERRIDES, SWEEPS, run_sweep, write_tables,
)
from stofnet_tpu_torch.data.synthetic import generate_chirp_dataset
from stofnet_tpu_torch.utils.config import load_config

SEED = 3008


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("epochs", nargs="?", type=int, default=None)
    p.add_argument("--out", default="build/chirp_sweep")
    p.add_argument("--device", default=None)
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    out = Path(args.out)
    epochs = args.epochs or (1 if args.smoke else 30)
    data = out / "stof_chirp101_dataset"
    if not data.exists():
        generate_chirp_dataset(
            data, **(dict(n_positions=2, n_train_per_pos=6,
                          n_test_per_pos=2, sample_num=160) if args.smoke
                     else dict(n_positions=4, n_train_per_pos=40,
                               n_test_per_pos=10, sample_num=800)))

    ckpts = {}
    for fam in ("stofnet", "edsr"):
        cfg = load_config(DEFAULT_CONFIG)
        cfg.update(data_dir=str(data), model=fam, epochs=epochs,
                   batch_size=2 if args.smoke else 8, rf_scale_factor=10, max_echoes=8,
                   crop_ratio=0.75, snr_db=30, seed=SEED, plot_interval=0,
                   run_dir=str(out / f"runs_train_{fam}"),
                   ckpt_dir=str(out / "ckpts"), device=args.device)
        ckpts[fam] = Path(run(cfg)["checkpoint"]).name

    rows = list(SWEEPS["chirp"]) + [
        ["stofnet", ckpts["stofnet"], None],
        ["edsr", ckpts["edsr"], None],
        ["stofnet", ckpts["stofnet"], None, {"int8": True}],
    ]
    scfg = load_config(DEFAULT_CONFIG)
    scfg.update(data_dir=str(data), ckpt_dir=str(out / "ckpts"),
                max_echoes=8, seed=SEED, run_dir=str(out / "runs_sweep"),
                save_artifacts=True, th_search_interval=10,
                device=args.device)
    scfg.update(SWEEP_OVERRIDES["chirp"])
    print(write_tables(run_sweep(scfg, rows), scfg.run_dir))


if __name__ == "__main__":
    main()
