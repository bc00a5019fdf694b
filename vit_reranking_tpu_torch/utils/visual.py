"""Host-side visualisation (matplotlib) of MSLS training inputs.

Port of the MSLS triptych of vit_reranking_tpu/utils/visual.py (reference
train_epoch.py:106-123); the OT heatmaps and retrieval strips come later.
Where matplotlib does not import, the figure is skipped and one line says
so.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.transforms import denormalize

_SKIPPED = []


def visual_msls_triptych(q_img: np.ndarray, p_img: np.ndarray, n_img: np.ndarray,
                         save_path: str = "triptych.png") -> bool:
    """Save the (query, positive, first negative) input triptych, normalised
    HWC images, to ``save_path``.  Returns False (having printed one line,
    the first time) where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        if not _SKIPPED:
            print("[visual] matplotlib is not installed: the MSLS input triptychs are skipped")
            _SKIPPED.append(True)
        return False
    fig, axs = plt.subplots(1, 3, figsize=(10, 5))
    for ax, img, title in zip(axs, (q_img, p_img, n_img), ("query", "pos", "neg")):
        ax.grid(False)
        ax.imshow(denormalize(np.asarray(img)))
        ax.set_title(title)
        ax.set_axis_off()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path)
    plt.close(fig)
    return True
