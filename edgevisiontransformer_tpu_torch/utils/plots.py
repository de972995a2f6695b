"""Plotting utilities — the reference's ``draw.py`` analogue (port of
``edgevisiontransformer_tpu/utils/plots.py``; matplotlib is imported
inside the functions, on the Agg backend).

MACs-vs-accuracy curves per model family (reference ``draw.py:5-120``) plus
a latency-vs-MACs plot fed by measurements.  The anchor table below is the
published-number set the reference embeds (``draw.py:13-40``) and doubles as
the accuracy-parity target table (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple


@dataclasses.dataclass
class ModelInfo:
    b_macs: float = 0.0
    acc: float = 0.0
    m_params: float = 0.0


# Published ImageNet anchors (reference draw.py:13-40).
MODEL_INFO: Dict[str, ModelInfo] = dict(
    deit_base=ModelInfo(17.7, 81.8),
    deit_small=ModelInfo(4.64, 79.9),
    deit_tiny=ModelInfo(1.28, 72.2),
    t2t_vit_14=ModelInfo(4.8, 81.5),
    t2t_vit_12=ModelInfo(1.8, 76.5),
    t2t_vit_10=ModelInfo(1.5, 75.2),
    t2t_vit_7=ModelInfo(1.1, 71.7),
    swin_base=ModelInfo(15.4, 83.5),
    swin_small=ModelInfo(8.7, 83.0),
    swin_tiny=ModelInfo(4.5, 81.3),
    efficientnet_b4=ModelInfo(4.2, 82.9),
    efficientnet_b0=ModelInfo(0.39, 77.1),
    resnet_50=ModelInfo(4.1, 76.0),
    mobilenet_v2=ModelInfo(0.3, 72.0),
    mobilenet_v3_large=ModelInfo(0.22, 75.6),
    proxyless_mobile=ModelInfo(0.32, 74.6),
)

FAMILIES: Dict[str, Sequence[str]] = {
    "deit": ("deit_tiny", "deit_small", "deit_base"),
    "t2t_vit": ("t2t_vit_7", "t2t_vit_10", "t2t_vit_12", "t2t_vit_14"),
    "swin": ("swin_tiny", "swin_small", "swin_base"),
    "efficientnet": ("efficientnet_b0", "efficientnet_b4"),
    "cnn": ("mobilenet_v2", "mobilenet_v3_large", "proxyless_mobile", "resnet_50"),
}


def draw_macs_accuracy_curve(out_path: str = "macs_accuracy.png",
                             extra_points: Optional[Dict[str, Tuple[float, float]]] = None):
    """Accuracy-vs-MACs per family (reference draw_macs_accuracy_curve)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for fam, names in FAMILIES.items():
        xs = [MODEL_INFO[n].b_macs for n in names]
        ys = [MODEL_INFO[n].acc for n in names]
        ax.plot(xs, ys, marker="^", label=fam)
    if extra_points:
        for name, (macs, acc) in extra_points.items():
            ax.scatter([macs], [acc], marker="*", s=120, label=name)
    ax.set_xlabel("GMACs")
    ax.set_ylabel("ImageNet top-1 (%)")
    ax.set_xscale("log")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def draw_latency_vs_macs(
    measurements: Dict[str, Tuple[float, float]],  # name -> (gmacs, ms)
    out_path: str = "latency_macs.png",
    title: str = "latency vs MACs",
):
    """Pruned-model latency-vs-MACs scatter (the proportionality check the
    flops grids predict, BASELINE.md)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for name, (macs, ms) in sorted(measurements.items()):
        ax.scatter([macs], [ms])
        ax.annotate(name, (macs, ms), fontsize=7)
    ax.set_xlabel("GMACs")
    ax.set_ylabel("latency (ms)")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
