"""The PALA and rat sweep tables with rows trained here (replaces
``scripts/run_pala_sweeps.py``)::

    python -m stofnet_tpu_torch.scripts.run_pala_sweeps [epochs] \\
        [--out DIR] [--device cpu --smoke]

The reference's checkpoints are not in the repository, so the rows of
``cli/sweep.SWEEPS["pala"]`` and ``["rat"]`` run from random weights and
carry the dagger. StofNet and EDSR are trained here on sequences 0 and 1
of a PALA stand-in generated under ``DIR`` (default
``build/pala_sweeps/pala_synth``: 3 sequences of 30 frames, 2 angles, 16
channels, 400 samples, 3 targets; rf_scale_factor 20: L=8000), then both
protocols run on the held-out sequence 2 with the trained rows added (and
StofNet through the int8 route): PALA's rows (``SWEEP_OVERRIDES["pala"]``)
and the in-vivo protocol's (``["rat"]``: th=1, ch_gap=1, etol=2).
Tables: ``DIR/runs_pala_sweep`` and ``DIR/runs_rat_sweep``
``metrics_table.{md,tex}``. ``--smoke``: 8 channels of 100 samples, 8
frames, 1 epoch, for a CPU run.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from stofnet_tpu_torch.cli.main import DEFAULT_CONFIG, run
from stofnet_tpu_torch.cli.sweep import (
    SWEEP_OVERRIDES, SWEEPS, run_sweep, write_tables,
)
from stofnet_tpu_torch.data.pala import generate_pala_dataset
from stofnet_tpu_torch.utils.config import load_config

SEED = 3008
TRAIN_SEQS = [0, 1]
EVAL_SEQS = [2]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("epochs", nargs="?", type=int, default=None)
    p.add_argument("--out", default="build/pala_sweeps")
    p.add_argument("--device", default=None)
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    out = Path(args.out)
    epochs = args.epochs or (1 if args.smoke else 25)
    data = out / "pala_synth"
    if not (data / "pala_config.yaml").exists():
        generate_pala_dataset(
            data, n_sequences=3, n_angles=2, seed=SEED,
            **(dict(n_frames=8, n_channels=8, n_samples=100, n_targets=2)
               if args.smoke else dict(n_frames=30, n_channels=16,
                                       n_samples=400, n_targets=3)))

    ckpts = {}
    for fam in ("stofnet", "edsr"):
        cfg = load_config(DEFAULT_CONFIG)
        cfg.update(data_dir=str(data), model=fam, sequences=TRAIN_SEQS,
                   epochs=epochs, batch_size=2 if args.smoke else 4,
                   rf_scale_factor=20, max_echoes=8, snr_db=30, seed=SEED,
                   plot_interval=0, run_dir=str(out / f"runs_train_{fam}"),
                   ckpt_dir=str(out / "ckpts"), device=args.device)
        ckpts[fam] = Path(run(cfg)["checkpoint"]).name

    for sweep, th in (("pala", None), ("rat", 1.0)):
        rows = list(SWEEPS[sweep]) + [
            ["stofnet", ckpts["stofnet"], th],
            ["edsr", ckpts["edsr"], th],
            ["stofnet", ckpts["stofnet"], th, {"int8": True}]]
        scfg = load_config(DEFAULT_CONFIG)
        scfg.update(data_dir=str(data), sequences=EVAL_SEQS,
                    ckpt_dir=str(out / "ckpts"), max_echoes=8, seed=SEED,
                    run_dir=str(out / f"runs_{sweep}_sweep"),
                    save_artifacts=False, th_search_interval=10,
                    device=args.device)
        scfg.update(SWEEP_OVERRIDES[sweep])
        print(f"===== {sweep} =====")
        print(write_tables(run_sweep(scfg, rows), scfg.run_dir))
        print()


if __name__ == "__main__":
    main()
