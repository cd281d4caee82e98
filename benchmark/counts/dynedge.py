"""Matrix-product FLOPs of a DynEdge forward at each event's valid length
(``n`` pulses; the padding is not work the model needs).  Per pulse: each
conv's two first-layer products (``self_dense``, ``nbr_dense``), the
second layer once per valid edge (``min(k, n - 1)`` of them), the
post-processing MLP; per event the readout MLP and the head.  kNN,
pooling and elementwise work are not counted.  A training step counts
three forwards (the backward's products are twice the forward's)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def forward_flops(model_cfg: Dict, n: np.ndarray) -> float:
    a = model_cfg["arguments"]["backbone"]["__model__"]["arguments"]
    n = np.asarray(n, np.float64)
    k = float(a["nb_neighbours"])
    edges = n * np.minimum(k, np.maximum(n - 1.0, 0.0))
    d_in = int(a["nb_inputs"])
    d = d_in + d_in + min(4, d_in) + 1          # features + global variables
    d_skip, per_pulse, per_edge = d, 0.0, 0.0
    for h1, h2 in a["dynedge_layer_sizes"]:
        per_pulse += 2 * 2 * d * h1
        per_edge += 2 * h1 * h2
        d = h2
        d_skip += h2
    for h in a["post_processing_layer_sizes"]:
        per_pulse += 2 * d_skip * h
        d_skip = h
    per_event = 0.0
    d = d_skip * len(a["global_pooling_schemes"])
    for h in list(a["readout_layer_sizes"]) + [1]:
        per_event += 2 * d * h
        d = h
    return float(per_pulse * n.sum() + per_edge * edges.sum()
                 + per_event * len(n))
