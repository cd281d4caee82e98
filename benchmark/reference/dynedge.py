"""Plain PyTorch fp32 reference of GraphNeT's DynEdge with one
``IdentityTask`` head (the QUESO energy model), for the check that decides
``correct``.  It imports nothing of the program: it reads the model's
layout from the configuration's frozen ``model.yml`` and takes its weights
by the program's parameter names.

What it computes (the published DynEdge, as ``graphnet_tpu_torch/models/
gnn/dynedge.py`` lays it out on dense-padded events):

* kNN of each pulse over the ``features_subset`` columns (self excluded,
  ties to the lower index; fewer than ``k`` other valid pulses leave edges
  out).  The distances are a frozen copy of the port's plain arithmetic
  (``graphnet_tpu_torch/ops/knn.py:24-77``: the float64 centre, the
  ``|a|^2 + |b|^2 - 2ab`` expansion), which the kNN kernel follows bit for
  bit, so exact ties and near ties rank alike on both sides;
* the global variables (masked feature means, the homophily of the first
  four columns over the edges, log10 of the pulse count) appended to every
  pulse;
* per conv ``(h1, h2)``: a message ``relu(relu(cat[x_i, x_j - x_i] W1 +
  b1) W2 + b2)``, the first layer linearised as ``x_i (W1a - W1b) + x_j
  W1b`` (the program's ``self_dense`` / ``nbr_dense`` leaves), summed over
  the valid edges, then a new kNN on the output's subset columns;
* the skip concatenation, the post-processing MLP, min / max / mean
  pooling over the valid pulses, the readout MLP (relu after every layer)
  and the task's affine map; the loss LogCosh of the prediction and
  log10 of the energy, the answer ``10 ** prediction``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

BIG = 1e30
_NEG, _POS = -1e30, 1e30


def init_std(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """Mean and standard deviation of a leaf's seeded weights: LeCun normal
    dense weights (fan-in: ``in`` of a ``[out, in]`` weight, ``h1`` of an
    ``[h1, h2]`` message kernel, which also takes ``1 / sqrt(k)`` of the
    sum over the k = 8 edges, so latents do not grow with depth), biases
    N(0, 0.1)."""
    if name.endswith("out_kernel"):
        return 0.0, 1.0 / math.sqrt(shape[0] * 8)
    if len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 0.1


def event_centre(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Frozen copy of ``graphnet_tpu_torch/ops/knn.py:24`` (the float64
    sum of the valid coordinates in index order, over the count, rounded
    once to float32)."""
    c = torch.where(mask[..., None], coords.float(), 0.0)
    n = mask.sum(dim=1, keepdim=True).clamp_min(1)
    e = ((c.view(torch.int32) >> 23) & 0xFF).clamp_min(1)
    nz = c != 0
    lo = torch.where(nz, e, 255).amin(dim=1)
    hi = torch.where(nz, e, 0).amax(dim=1)
    clog = torch.log2(n.double()).ceil().long()
    exact = (hi < 255) & (hi - lo + 24 + clog <= 53)
    s = c.double().sum(dim=1) + 0.0
    if not bool(exact.all()):
        serial = c.double().cpu().cumsum(dim=1)[:, -1].to(c.device)
        s = torch.where(exact, s, serial)
    return (s / n.double()).float()


def sq_dists(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Frozen copy of ``graphnet_tpu_torch/ops/knn.py:53-77``: ``[B, L,
    L]`` squared distances after centring; pairs with a padded pulse
    ``BIG``."""
    c = coords.float() - event_centre(coords, mask)[:, None, :]
    sq = c[..., 0] * c[..., 0]
    cross = c[:, :, None, 0] * c[:, None, :, 0]
    for d in range(1, c.shape[-1]):
        sq = sq + c[..., d] * c[..., d]
        cross = cross + c[:, :, None, d] * c[:, None, :, d]
    d2 = ((sq[:, :, None] + sq[:, None, :]) - 2.0 * cross).clamp_min(0.0)
    valid = mask[:, :, None] & mask[:, None, :]
    return torch.where(valid, d2, BIG)


def knn(coords: torch.Tensor, mask: torch.Tensor, k: int):
    """``(idx [B, L, k] int64, edge_mask [B, L, k])``: the k nearest other
    valid pulses by a stable sort."""
    d2 = sq_dists(coords, mask)
    L = d2.shape[1]
    d2 = d2.masked_fill(torch.eye(L, dtype=torch.bool, device=d2.device), BIG)
    chosen, idx = torch.sort(d2, dim=-1, stable=True)
    idx, chosen = idx[..., :k], chosen[..., :k]
    return idx, (chosen < BIG * 0.5) & mask[:, :, None]


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, L, k = idx.shape
    flat = idx.reshape(B, L * k, 1).expand(B, L * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, L, k, x.shape[-1])


def masked_pool(x: torch.Tensor, mask: torch.Tensor, scheme: str):
    m = mask[..., None]
    if scheme == "mean":
        return torch.where(m, x, 0.0).sum(1) / mask.sum(1, keepdim=True).clamp_min(1)
    if scheme == "sum":
        return torch.where(m, x, 0.0).sum(1)
    any_ = mask.any(1, keepdim=True)
    if scheme == "max":
        return torch.where(any_, torch.where(m, x, _NEG).amax(1), 0.0)
    if scheme == "min":
        return torch.where(any_, torch.where(m, x, _POS).amin(1), 0.0)
    raise ValueError(f"pooling {scheme!r}")


class Model:
    """The reference of one configuration: ``Model(model_cfg, weights)``,
    ``weights`` a ``{program parameter name: tensor}`` dict."""

    def __init__(self, model_cfg: Dict, weights: Dict[str, torch.Tensor]):
        bb = model_cfg["arguments"]["backbone"]["__model__"]["arguments"]
        (task,) = model_cfg["arguments"]["tasks"]
        task = task["__model__"]
        if task["class_name"] != "IdentityTask":
            raise NotImplementedError(task["class_name"])
        args = task["arguments"]
        if (args["loss_function"]["__model__"]["class_name"] != "LogCoshLoss"
                or args["transform_target"] != {"__transform__": "log10"}
                or args["transform_inference"] != {"__transform__": "pow10"}):
            raise NotImplementedError("the energy task of the QUESO model")
        if bb.get("add_global_variables_after_pooling") or bb.get("add_norm_layer"):
            raise NotImplementedError("global variables after pooling, norms")
        self.k = int(bb["nb_neighbours"])
        self.subset = list(bb["features_subset"])
        self.n_convs = len(bb["dynedge_layer_sizes"])
        self.post = len(bb["post_processing_layer_sizes"])
        self.readout = len(bb["readout_layer_sizes"])
        self.pooling = list(bb["global_pooling_schemes"])
        self.target = args["target_labels"][0]
        self.w = weights

    def _dense(self, name: str, x: torch.Tensor, bias: bool = True):
        return F.linear(x, self.w[f"{name}.weight"],
                        self.w[f"{name}.bias"] if bias else None)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                n_pulses: torch.Tensor, graphs=None, record=None) -> torch.Tensor:
        """The task's prediction before the inference transform, ``[B, 1]``.

        ``graphs``: the kNN graphs another forward of these events built
        (``harness/capture.py``), in its order; conv i >= 1 then reads the
        i-th instead of building its own from its input's near ties.
        ``record``: a list that gets the graphs this forward builds."""
        B, L = mask.shape

        def graph(i, coords):
            g = graphs[i] if graphs is not None and i < len(graphs) else None
            if (i > 0 and g is not None and g["idx"].shape[0] >= B
                    and g["idx"].shape[1] >= L):
                em = g["edge_mask"][:B, :L]
                return torch.where(em, g["idx"][:B, :L].long(), 0), em
            idx, em = knn(coords, mask, self.k)
            if record is not None:
                record.append({"coords": coords.detach().clone(), "mask": mask,
                               "k": self.k, "idx": idx, "edge_mask": em})
            return idx, em

        idx, em = graph(0, x[..., self.subset])
        nbr = gather(x[..., :4], idx)
        same = (x[:, :, None, :4] == nbr) & em[..., None]
        hom = same.sum((1, 2)).float() / em.sum((1, 2)).clamp_min(1)[:, None]
        means = masked_pool(x, mask, "mean")
        logn = torch.log10(n_pulses.clamp_min(1).float())[:, None]
        g = torch.cat([means, hom, logn], -1)
        x = torch.cat([x, g[:, None, :].expand(-1, x.shape[1], -1)], -1)
        skips = [x]
        for i in range(self.n_convs):
            p = f"backbone.conv_{i}.conv"
            a = self._dense(f"{p}.self_dense", x)
            b = self._dense(f"{p}.nbr_dense", x, bias=False)
            msgs = torch.relu(a[:, :, None, :] + gather(b, idx))
            msgs = torch.relu(msgs @ self.w[f"{p}.out_kernel"]
                              + self.w[f"{p}.out_bias"])
            x = torch.where(em[..., None], msgs, 0.0).sum(2)
            skips.append(x)
            if i + 1 < self.n_convs:
                idx, em = graph(i + 1, x[..., self.subset])
        x = torch.cat(skips, -1)
        for i in range(self.post):
            x = torch.relu(self._dense(f"backbone.post_processing.dense_{i}", x))
        x = torch.cat([masked_pool(x, mask, s) for s in self.pooling], -1)
        for i in range(self.readout):
            x = torch.relu(self._dense(f"backbone.readout.dense_{i}", x))
        return self._dense("tasks_0.affine", x)

    def answer(self, pred: torch.Tensor) -> torch.Tensor:
        """The served columns: ``10 ** prediction``."""
        return torch.pow(10.0, pred)

    follows_graphs = True

    @staticmethod
    def answer_scale(answers):
        """The scale of a served energy's gap: the energy itself."""
        return abs(answers)

    def loss(self, pred: torch.Tensor, labels: Dict[str, torch.Tensor],
             rows: slice = slice(None)) -> torch.Tensor:
        """Mean LogCosh over the events ``rows`` (all of them by default)."""
        d = pred[rows, 0] - torch.log10(labels[self.target][rows].float())
        return (d + F.softplus(-2.0 * d) - math.log(2.0)).mean()
