"""Re-derive the analysis fields of dry-run records from their saved
(compressed) op logs — no re-trace; the counterpart of
``repro.launch.reanalyze``. Run after analyzer changes:

    PYTHONPATH=src python -m repro_torch.launch.reanalyze
"""
from __future__ import annotations

import glob
import json
import lzma
import os

from repro_torch.launch.dryrun import analysis_dict, log_path
from repro_torch.launch.hlo_analysis import analyze_hlo

RESULTS_DIR = os.environ.get("REPRO_RESULTS_DIR", "results")


def reanalyze_all() -> int:
    """Rewrite ``analysis`` and the step's FLOPs and bytes of every ``ok``
    record under ``$REPRO_RESULTS_DIR/dryrun_torch`` that has its log.
    Returns the number of records rewritten."""
    n = 0
    for jpath in sorted(glob.glob(os.path.join(RESULTS_DIR, "dryrun_torch", "*.json"))):
        lpath = log_path(jpath)
        if not os.path.exists(lpath):
            continue
        with open(jpath) as f:
            cell = json.load(f)
        if cell.get("status") != "ok":
            continue
        with lzma.open(lpath, "rt") as f:
            a = analyze_hlo(f.read())
        cell["analysis"] = analysis_dict(a, cell["n_devices"])
        cell["step"].update(flops=a.flops, hbm_bytes=a.hbm_bytes)
        with open(jpath, "w") as f:
            json.dump(cell, f, indent=2)
        n += 1
    return n


if __name__ == "__main__":
    print(f"re-analyzed {reanalyze_all()} cells")
