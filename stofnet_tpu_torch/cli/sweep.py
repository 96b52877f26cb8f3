"""Benchmark sweep runner and results table (replaces
``stofnet_tpu/cli/sweep.py``; its tables, notes and formatter are copies).

The reference's SLURM array scripts (``bash_scripts/*.sh``, one GPU job a
(model, checkpoint, threshold) row) and its W&B-scraping table generator
(``utils/load_table_contents.py``) become one in-process sweep: the rows
run one after another through ``cli/main.run`` (on the card unless
``device=cpu``), and the table comes out locally as markdown and LaTeX in
the reference's schema: RMSE [sample] ±std, Jaccard [%], Weights [k#],
Time [ms]. A row whose checkpoint prefix is not in ``ckpt_dir=`` runs from
random weights and carries a dagger; a row that raises is recorded as
``error`` and the sweep goes on.

Usage:
    python -m stofnet_tpu_torch.cli.sweep sweep=chirp data_dir=... [key=value ...]
    python -m stofnet_tpu_torch.cli.sweep rows='[[stofnet,different-armadillo,null]]'
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from stofnet_tpu_torch.cli.main import DEFAULT_CONFIG
from stofnet_tpu_torch.utils.config import Config, load_config, merge_cli

# the reference's sweep rows (bash_scripts/array_*_params.txt); optional
# 4th element = per-row config overrides (e.g. the no-SemiGlobalBlock
# StofNet ablation checkpoints require semi_global_scale=1, which the
# reference's CLI could not even express)
SWEEPS: Dict[str, List[List[Any]]] = {
    "chirp": [  # model, ckpt-prefix, threshold (rf_scale 10, etol 1)
        ["stofnet", "different-armadillo", None],
        ["stofnet", "clean-serenity", None, {"semi_global_scale": 1}],
        ["edsr", "proud-cherry", None],
        ["sincnet", "pretty-brook", None],
        ["espcn", "vital-puddle", None],
        ["zonzini", "graceful-wave", None],
        ["gradpeak", None, None],
    ],
    "pala": [  # rf_scale 20 (array_pala_params.txt)
        ["stofnet", "graceful-snow", 0.015],
        ["stofnet", "breezy-violet", 2.3, {"semi_global_scale": 1}],
        ["edsr", "snowy-dragon", 1.5],
        ["sincnet", "noble-monkey", 4.2],
        ["espcn", "wobbly-sponge", 0.2],
        ["zonzini", "polar-sun", None],
        ["gradpeak", None, 1e-5],
    ],
    # in-vivo protocol (rat_benchmark.sh:36): th=1, ch_gap=1, etol=2 applied
    # via the sweep-level config overrides below
    "rat": [
        ["stofnet", "graceful-snow", 1.0],
        ["stofnet", "breezy-violet", 1.0, {"semi_global_scale": 1}],
        ["edsr", "snowy-dragon", 1.0],
        ["sincnet", "noble-monkey", 1.0],
        ["espcn", "wobbly-sponge", 1.0],
        ["zonzini", "polar-sun", 1.0],
        ["gradpeak", None, 1.0],
    ],
}

SWEEP_OVERRIDES = {  # per-protocol config defaults (bash_scripts/*.sh)
    "chirp": {"rf_scale_factor": 10, "etol": 1, "batch_size": 1},
    "pala": {"rf_scale_factor": 20, "etol": 1, "batch_size": 1},
    "rat": {"rf_scale_factor": 20, "etol": 2, "ch_gap": 1, "batch_size": 1},
}

CITATIONS = {  # row labels used in the reference's paper table
    "stofnet": "StofNet",
    "edsr": "EDSR~\\cite{lim2017enhanced}",
    "sincnet": "SincNet~\\cite{ravanelli2018speaker}",
    "espcn": "ESPCN~\\cite{shi2016real}",
    "zonzini": "Zonzini~\\cite{zonzini2022machine}",
    "gradpeak": "GradPeak",
    "kuleshov": "Kuleshov~\\cite{kuleshov2017audio}",
    "unet": "Wave-U-Net~\\cite{stoller2018wave}",
}


def run_sweep(cfg: Config, rows: Sequence[Sequence[Any]]) -> List[Dict[str, Any]]:
    from stofnet_tpu_torch.cli.main import run

    results = []
    for row in rows:
        model, ckpt, th = (list(row) + [None, None])[:3]
        extra = row[3] if len(row) > 3 and isinstance(row[3], dict) else {}
        rcfg = cfg.copy()
        rcfg.update(model=model, model_file=ckpt, th=th, evaluate=True,
                    **extra)
        print(f"=== sweep row: model={model} ckpt={ckpt} th={th}",
              file=sys.stderr)
        try:
            out = run(rcfg)
        except Exception as e:  # one broken row must not kill the sweep
            print(f"row failed: {type(e).__name__}: {e}", file=sys.stderr)
            out = {"model_name": model, "error": str(e)}
        out["model"] = model
        out["ckpt"] = ckpt
        results.append(out)
    return results


TIMING_NOTE = ("Time [ms] is the nan-mean of forward time / batch_size; "
               "the FIRST batch is excluded (recorded NaN) because it is "
               "dominated by jit compilation — the reference, which has no "
               "compile step, includes its first-batch warmup "
               "(main.py:313-315,350).")
RANDOM_INIT_NOTE = ("checkpoint prefix not found — row ran with RANDOM-INIT "
                    "weights (reference no-crash semantics, main.py:174-177);"
                    " its metrics do not reflect trained weights.")


def format_table(results: List[Dict[str, Any]], latex: bool = False) -> str:
    """RMSE ±std / Jaccard / Weights / Time schema
    (utils/load_table_contents.py:84-112), with integrity footnotes: the
    first-batch timing exclusion is always noted, and rows whose checkpoint
    was missing (random-init run) carry a dagger."""
    lines = []
    any_random = any(r.get("random_init") for r in results)
    if latex:
        lines += [
            "\\begin{tabular}{l|cccc}",
            "Method & RMSE [sample] & Jaccard [\\%] & Weights [k\\#]"
            " & Time [ms] \\\\",
            "\\hline",
        ]
    else:
        lines += [
            "| Method | RMSE [sample] | Jaccard [%] | Weights [k#] | Time [ms] |",
            "|---|---|---|---|---|",
        ]
    for r in results:
        label = (CITATIONS.get(r["model"], r["model"]) if latex
                 else r["model"] + (f" ({r['ckpt']})" if r.get("ckpt") else ""))
        if r.get("int8"):
            # quantized serving row (models/int8.py via CLI int8=True)
            label += " (int8)" if latex else " [int8]"
        if r.get("random_init"):
            label += "$^\\dagger$" if latex else " †"
        if "error" in r:
            cells = [label, "error", "-", "-", "-"]
        else:
            w = r.get("total_parameters")
            cells = [
                label,
                f"{r.get('total_distance_mean', float('nan')):.2f}"
                f" ±{r.get('total_distance_std', float('nan')):.2f}",
                f"{r.get('total_jaccard', float('nan')):.1f}",
                f"{w / 1000:.1f}" if w else "-",
                f"{1000 * r.get('total_inference_time', float('nan')):.2f}",
            ]
        lines.append(" & ".join(cells) + " \\\\" if latex
                     else "| " + " | ".join(cells) + " |")
    if latex:
        lines.append("\\end{tabular}")
        lines.append("\\par\\footnotesize " + TIMING_NOTE)
        if any_random:
            lines.append("\\par\\footnotesize $\\dagger$ "
                         + RANDOM_INIT_NOTE)
    else:
        lines.append("")
        lines.append("Note: " + TIMING_NOTE)
        if any_random:
            lines.append("† " + RANDOM_INIT_NOTE)
    return "\n".join(lines)


def sweep_comparison_figure(results: List[Dict[str, Any]],
                            run_dir: Path) -> Optional[Path]:
    """Cross-model comparison figure from the per-run frame artifacts: one
    waveform with every model's ToA markers + GT and a zoom inset — the
    reference's paper figure (utils/load_table_contents.py:115-116 ->
    plot_frame.stofnet_plot). Returns the saved path, or None when no
    artifacts exist (save_artifacts=False runs)."""
    frames = []
    for r in results:
        if "error" in r or not r.get("run_name"):
            continue
        art = sorted((run_dir / f"{r['run_name']}_frames").glob("frame_*.npz"))
        if art:
            frames.append((r["model"], np.load(art[0])))
    if not frames:
        return None
    try:
        import matplotlib.pyplot as plt

        from stofnet_tpu_torch.utils.plotting import plot_comparison
    except Exception:
        return None

    # all rows evaluate the same deterministic batch order, so artifact 0
    # is the same frame for every model
    _, first = frames[0]
    path = run_dir / "sweep_comparison.png"
    fig = plot_comparison(
        first["data"][0, 0],
        [art["toa"][0] for _, art in frames],
        [name for name, _ in frames],
        gt_samples=first["gt"][0],
        save_path=str(path),
    )
    plt.close(fig)
    return path


def write_tables(results: List[Dict[str, Any]], run_dir) -> str:
    """Attach per-run summary keys (total_parameters, random_init, ...)
    and write metrics_table.{md,tex} under ``run_dir``; returns the
    markdown. Shared by the sweep CLI and the table-regeneration scripts
    so the integrity markers / schema can never diverge between them."""
    import json

    run_dir = Path(run_dir)
    for r in results:
        if "total_parameters" not in r and r.get("run_name"):
            summary = run_dir / f"{r['run_name']}_summary.json"
            if summary.exists():
                r.update(json.loads(summary.read_text()))
    run_dir.mkdir(parents=True, exist_ok=True)
    md = format_table(results)
    (run_dir / "metrics_table.md").write_text(md + "\n")
    (run_dir / "metrics_table.tex").write_text(
        format_table(results, latex=True) + "\n")
    return md


def main(argv: Optional[list] = None) -> None:
    args = list(argv) if argv is not None else sys.argv[1:]
    cfg = merge_cli(load_config(DEFAULT_CONFIG), args)
    sweep_name = cfg.get("sweep", "chirp")
    rows = cfg.get("rows") or SWEEPS[sweep_name]
    explicit = {a.split("=")[0] for a in args}
    for k, v in SWEEP_OVERRIDES.get(sweep_name, {}).items():
        if k not in explicit:
            cfg[k] = v

    results = run_sweep(cfg, rows)

    out_dir = Path(cfg.get("run_dir", "runs"))
    md = write_tables(results, out_dir)
    fig = sweep_comparison_figure(results, out_dir)
    if fig is not None:
        print(f"comparison figure: {fig}", file=sys.stderr)
    print(md)


if __name__ == "__main__":
    main()
