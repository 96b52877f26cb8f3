"""Post-hoc benchmark report (replaces ``stofnet_tpu/cli/report.py``, a
copy): the paper table and the comparison figure rebuilt from past runs,
without running anything.

The reference (``utils/load_table_contents.py``) pulls the last 7 runs of
a W&B group through the cloud API. Here the source is local: every run
writes ``<run_dir>/<run_name>_summary.json`` and its
``<run_name>_frames/*.npz`` (``utils/logging.py``), so the report works
offline; with ``wandb_group=`` and the W&B API reachable, the summaries
come from the cloud as in the reference. Without ``wandb`` installed the
local summaries are used.

Usage:
    python -m stofnet_tpu_torch.cli.report run_dir=runs [num_recent=7]
    python -m stofnet_tpu_torch.cli.report wandb_group=chirp_array
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from stofnet_tpu_torch.cli.sweep import format_table, sweep_comparison_figure


def local_results(run_dir: Path, num_recent: int) -> List[Dict[str, Any]]:
    """Most recent runs' summaries from <run_dir>/*_summary.json."""
    files = sorted(run_dir.glob("*_summary.json"),
                   key=lambda p: p.stat().st_mtime, reverse=True)
    results = []
    for path in files[:num_recent]:
        summary = json.loads(path.read_text())
        run_name = path.name[: -len("_summary.json")]
        results.append({
            "run_name": run_name,
            "model": summary.get("model_name", run_name),
            "ckpt": summary.get("checkpoint"),
            **summary,
        })
    return results


def wandb_results(group: str, num_recent: int) -> Optional[List[Dict[str, Any]]]:
    """The reference's cloud path (load_table_contents.py:8-41): last-N
    finished runs of a group via the W&B API. Returns None when wandb or
    the API is unavailable (offline harness) so callers fall back."""
    try:
        import wandb  # optional dependency

        api = wandb.Api()
        runs = [r for r in api.runs("stofnet_tpu") if r.group == group]
    except Exception as e:
        print(f"wandb pull unavailable ({type(e).__name__}); "
              f"using local summaries", file=sys.stderr)
        return None
    runs = sorted(runs, key=lambda r: r.created_at, reverse=True)[:num_recent]
    results = []
    for r in runs:
        s = dict(r.summary)
        results.append({"run_name": r.name,
                        "model": s.get("model_name", r.name), **s})
    return results


def main(argv: Optional[list] = None) -> None:
    raw = argv if argv is not None else sys.argv[1:]
    bad = [a for a in raw if "=" not in a]
    if bad:
        print(f"arguments must be key=value (got {bad!r}); e.g. "
              f"run_dir=runs num_recent=7 wandb_group=chirp_array",
              file=sys.stderr)
        raise SystemExit(2)
    args = dict(a.split("=", 1) for a in raw)
    run_dir = Path(args.get("run_dir", "runs"))
    num_recent = int(args.get("num_recent", 7))

    results = None
    if args.get("wandb_group"):
        results = wandb_results(args["wandb_group"], num_recent)
    if results is None:
        results = local_results(run_dir, num_recent)
    if not results:
        print(f"no run summaries under {run_dir}", file=sys.stderr)
        raise SystemExit(1)

    md = format_table(results)
    tex = format_table(results, latex=True)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "metrics_table.md").write_text(md + "\n")
    (run_dir / "metrics_table.tex").write_text(tex + "\n")
    fig = sweep_comparison_figure(results, run_dir)
    if fig is not None:
        print(f"comparison figure: {fig}", file=sys.stderr)
    print(md)


if __name__ == "__main__":
    main()
