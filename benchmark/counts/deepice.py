"""Matrix-product FLOPs of a DeepIce forward at each event's valid length
(``n`` pulses; the blocks after the cls token see ``n + 1``).  Per token:
the Fourier MLP, each block's projections and MLP; per event and block
the attention products ``q k^T`` and ``a v`` over the valid keys, and in
the biased blocks ``q . rel`` and ``a . rel`` and the pair projection
folded into q;
the head.  Sinusoids, norms and softmax are not counted.  A training
step counts three forwards."""

from __future__ import annotations

from typing import Dict

import numpy as np


def forward_flops(model_cfg: Dict, n: np.ndarray) -> float:
    a = model_cfg["arguments"]["backbone"]["__model__"]["arguments"]
    n = np.asarray(n, np.float64)
    D, hd, seq = int(a["hidden_dim"]), int(a["head_size"]), int(a["seq_length"])
    mlp = int(a["mlp_ratio"]) * D
    fourier = 2 * (6 * seq) * (6 * seq) + 2 * (6 * seq) * D
    block = 2 * 4 * D * D + 2 * 2 * D * mlp     # projections + MLP, a token
    attn = 2 * 2 * D                            # q k^T + a v, a (query, key)
    rel = min(int(a["n_rel"]), int(a["depth_rel"]))
    flops = fourier * n.sum()
    flops += int(a["depth_rel"]) * (block * n.sum() + attn * (n * n).sum())
    # q . rel and a . rel a pair, and the pair projection folded into q
    # (q W a token and head), as the rel kernels compute it
    flops += rel * (2 * 2 * D * (n * n).sum() + 2 * D * hd * n.sum())
    m = n + 1
    flops += int(a["depth"]) * (block * m.sum() + attn * (m * m).sum())
    flops += 2 * D * 3 * len(n)
    return float(flops)
