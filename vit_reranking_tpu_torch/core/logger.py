"""Run logging: run-dir creation with a dedup counter, per-group CSV
writers, optional SVG curves, parameter snapshot.

Port of vit_reranking_tpu/core/logger.py (reference utilities/logger.py:
64-159) with the CSV and SVG outputs; the online (wandb/comet) hooks come
later.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, List


class CSVWriter:
    """Append-mode CSV with a fixed header (reference logger.py:8-25)."""

    def __init__(self, path: str, columns: List[str]):
        self.path = path
        self.columns = list(columns)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self.columns)

    def log(self, values):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(list(values))


class RunLogger:
    """``{save_path}/{dataset}/{group}_s{seed}`` (``_v{n}`` appended while the
    directory exists), with ``Parameter_Info.txt``, ``hypa.json`` and one
    ``log_{group}.csv`` per logged group."""

    def __init__(self, opt, sub_loggers=("Train", "Test"), start_new: bool = True):
        self.opt = opt
        name = f"{opt.group}_s{opt.seed}"  # run identity (train_baseline.py:35)
        run_dir = os.path.join(opt.save_path, opt.dataset, name)
        if start_new:
            counter = 1
            probe = run_dir
            while os.path.exists(probe):
                probe = f"{run_dir}_v{counter}"
                counter += 1
            run_dir = probe
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.csvs: Dict[str, CSVWriter] = {}
        self.history: Dict[str, Dict[str, list]] = {s: defaultdict(list) for s in sub_loggers}
        self._dump_params()

    def _dump_params(self):
        d = dataclasses.asdict(self.opt)
        with open(os.path.join(self.run_dir, "Parameter_Info.txt"), "w") as f:
            for k, v in sorted(d.items()):
                f.write(f"{k}: {v}\n")
        with open(os.path.join(self.run_dir, "hypa.json"), "w") as f:
            json.dump({k: str(v) for k, v in sorted(d.items())}, f, indent=1)

    def log(self, sub: str, metrics: Dict[str, float], step: int):
        history = self.history.setdefault(sub, defaultdict(list))
        for k, v in metrics.items():
            history[k].append(float(v))
        if sub not in self.csvs:
            self.csvs[sub] = CSVWriter(
                os.path.join(self.run_dir, f"log_{sub.lower()}.csv"),
                ["step"] + sorted(metrics.keys()),
            )
        self.csvs[sub].log([step] + [float(metrics[k]) for k in sorted(metrics.keys())])

    def plot_curves(self):
        """SVG training curves (reference InfoPlotter, logger.py:30-60); does
        nothing where matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        for sub, series in self.history.items():
            if not series:
                continue
            fig, ax = plt.subplots(1, 1, figsize=(8, 5))
            for k, vals in series.items():
                ax.plot(vals, label=k)
            ax.legend(fontsize=7)
            ax.set_title(sub)
            fig.savefig(os.path.join(self.run_dir, f"curves_{sub.lower()}.svg"))
            plt.close(fig)
