"""Diagnostic plots of the train stage (counterpart of
saspa_tpu/fgvc/plots.py).

The reference's get_a_plot_of_num_samples_per_class_vs_class_accuracy
(fgvc/util.py:112-135): a scatter of each class's train samples against
its accuracy, one PNG a validation and test, behind `cli train
--plot_per_class_acc` (the reference keeps its call sites commented out,
fgvc/train.py:363-364,376-377).  matplotlib is imported at the call, with
the Agg backend; `require_matplotlib` lets the runner fail before its first
step where it is not installed.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict


def require_matplotlib() -> None:
    """Raises an ImportError that names matplotlib where it is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("--plot_per_class_acc needs matplotlib, which is not installed here; run without the "
                          "flag, or where matplotlib is installed") from e


def plot_samples_per_class_vs_accuracy(num_samples_per_class: Dict[int, int], class_accuracies: Dict[int, float],
                                       epoch: int, output_folder: str):
    """Scatter of samples per class (x) against class accuracy (y), both
    dicts taken in sorted key order; saves
    num_samples_per_class_vs_class_accuracy_epoch_{epoch}.png under
    output_folder and returns the figure."""
    import matplotlib

    matplotlib.use("Agg")  # no display on the card's machine
    import matplotlib.pyplot as plt

    Path(output_folder).mkdir(parents=True, exist_ok=True)
    xs = [v for _, v in sorted(num_samples_per_class.items())]
    ys = [v for _, v in sorted(class_accuracies.items())]
    fig, ax = plt.subplots()
    ax.set_xlabel("Number of samples per class")
    ax.set_ylabel("Class accuracy", color="tab:blue")
    ax.scatter(xs, ys, color="tab:blue")
    ax.tick_params(axis="y", labelcolor="tab:blue")
    fig.tight_layout()
    out = Path(output_folder) / f"num_samples_per_class_vs_class_accuracy_epoch_{epoch}.png"
    fig.savefig(out)
    logging.info("per-class accuracy plot: %s", out)
    return fig
