"""NodeRNN, a GRU over each sensor's pulse series that turns an event's
pulses into sensor nodes (counterpart of
``graphnet_tpu/models/rnn/node_rnn.py``).

The input comes from
:class:`~graphnet_tpu_torch.models.graphs.nodes.NodeAsDOMTimeSeries`:
the pulses grouped per sensor in time order, the last column
``new_node_col`` 1 at each sensor's first pulse.  The JAX package runs
one scan over the padded pulse axis with the hidden state reset at the
markers; the port runs each series on its own from a zero state (a run
starts at the first pulse and at every marker), which is the same
recurrence: the runs sorted by length, one ``torch.gru_cell`` step over
the runs still going at each position (on the card the fused GRU cell
and two fp32 products a step, no cuDNN, whose RNNs take TF32 products
by default), so the loop is as long as the longest series, not the
event.  The GRU is flax's ``GRUCell``, re-laid as torch's: flax has a
bias on the three input projections and on the hidden one of the
candidate only, so torch's hidden biases of the reset and update gates
are zero.  Layers past ``final_state_layer`` change no output (GraphNeT
computes them and reads the first layer's state), so they are not run.
It is not a Pallas kernel in the JAX package, so it is plain PyTorch
here.

Each sensor node is ``[its first pulse's features with charge replaced by
asinh of the sensor's charge sum, the GRU state after its last pulse]``
(the state of the layer ``final_state_layer``, GraphNeT's first by
default), compacted to the front of the node axis; ``n_pulses`` keeps
the pulse count, as in GraphNeT.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from graphnet_tpu_torch.batch import EventBatch
from graphnet_tpu_torch.models.components.embedding import SinusoidalPosEmb
from graphnet_tpu_torch.models.components import stochastic
from graphnet_tpu_torch.models.components.stochastic import Dropout
from graphnet_tpu_torch.models.gnn.gnn import GNN
from graphnet_tpu_torch.utils.config import save_config


class GRUCell(nn.Module):
    """The parameters of flax's ``GRUCell`` under its names: input
    projections ``ir``, ``iz``, ``in`` with biases, hidden projections
    ``hr``, ``hz`` without and ``hn`` with one."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for gate in ("r", "z", "n"):
            self.add_module(f"i{gate}", nn.Linear(in_features, features))
            self.add_module(f"h{gate}", nn.Linear(features, features,
                                                  bias=gate == "n"))

    def torch_weights(self) -> List[torch.Tensor]:
        """``[w_ih, w_hh, b_ih, b_hh]`` of torch's GRU layout (gate rows
        r, z, n)."""
        get = self.get_submodule
        w_ih = torch.cat([get(f"i{g}").weight for g in "rzn"])
        w_hh = torch.cat([get(f"h{g}").weight for g in "rzn"])
        b_ih = torch.cat([get(f"i{g}").bias for g in "rzn"])
        zero = torch.zeros_like(get("hn").bias)
        b_hh = torch.cat([zero, zero, get("hn").bias])
        return [w_ih, w_hh, b_ih, b_hh]


class _Cell(nn.Module):
    """Holds the cell as ``gru`` (the flax scan's ``cell/gru`` path)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.gru = GRUCell(in_features, features)


class _ResettingGRULayer(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.cell = _Cell(in_features, features)


def _runs(mask: torch.Tensor, new_node: torch.Tensor):
    """The GRU runs of a batch: each valid pulse's global run id and step
    in its run, and each run's length.  A run starts at an event's first
    pulse and at every marker."""
    B, L = mask.shape
    pos = torch.arange(L, device=mask.device)
    start = (new_node | (pos == 0)[None, :]) & mask
    n_runs = start.sum(dim=1)
    offset = torch.cumsum(n_runs, dim=0) - n_runs
    run = offset[:, None] + torch.cumsum(start.long(), dim=1) - 1
    first = torch.cummax(torch.where(start, pos, 0), dim=1).values
    return run, pos - first, n_runs


class NodeRNN(GNN):
    """Arguments and defaults are the JAX package's.  Returns the batch
    of sensor nodes (``x [B, L, D - 1 + hidden_size]``, ``mask`` the
    valid sensors, no edges).  Dropout of ``dropout`` between the GRU
    layers is on with ``deterministic=False`` in training mode; its mask
    is drawn over the padded pulses ``[B, L, hidden_size]``, the JAX
    package's layout, and applied to the runs.  Only a layer that feeds
    ``final_state_layer`` is run, so with GraphNeT's default (the first
    layer's state) the dropout changes no output and draws nothing."""

    @save_config
    def __init__(
        self,
        nb_inputs: int,
        hidden_size: int,
        num_layers: int,
        time_series_columns: Tuple[int, ...],
        nb_neighbours: int = 8,
        features_subset: Optional[Tuple[int, ...]] = None,
        dropout: float = 0.5,
        embedding_dim: int = 0,
        deterministic: bool = True,
        final_state_layer: int = 0,
    ):
        super().__init__()
        if not 0 <= final_state_layer < num_layers:
            raise ValueError(
                f"final_state_layer={final_state_layer} out of range for "
                f"num_layers={num_layers}")
        self.nb_inputs = nb_inputs
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_series_columns = list(time_series_columns)
        self.embedding_dim = embedding_dim
        self.final_state_layer = final_state_layer
        self.drop = Dropout(dropout, deterministic)
        d = len(self.time_series_columns)
        if embedding_dim:
            self.emb = SinusoidalPosEmb(embedding_dim)
            d *= embedding_dim
        for layer in range(num_layers):
            setattr(self, f"gru_{layer}",
                    _ResettingGRULayer(d if layer == 0 else hidden_size,
                                       hidden_size))

    @property
    def nb_outputs(self) -> int:
        return self.hidden_size + 5

    def _run_states(self, ts: torch.Tensor, mask: torch.Tensor,
                    new_node: torch.Tensor):
        """``(run of each pulse [B, L], final state of each run [R, H])``
        of the layer ``final_state_layer``."""
        run, step, n_runs = _runs(mask, new_node)
        R = int(n_runs.sum())
        if R == 0:
            return run, ts.new_zeros((0, self.hidden_size))
        lengths = torch.bincount(run[mask], minlength=R)
        # the runs longest first, so those still going at a step are a
        # prefix: going[t] of them
        order = torch.argsort(lengths, descending=True, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(R, device=order.device)
        going = torch.bincount(lengths.cpu() - 1).flip(0).cumsum(0).flip(0)
        xs = ts.new_zeros((R, len(going), ts.shape[-1]))
        rows, steps = rank[run[mask]], step[mask]
        xs[rows, steps] = ts[mask]
        for layer in range(self.final_state_layer + 1):
            weights = getattr(self, f"gru_{layer}").cell.gru.torch_weights()
            h = ts.new_zeros((R, self.hidden_size))
            ys = [] if layer < self.final_state_layer else None
            for t, n in enumerate(going.tolist()):
                h = torch.cat([torch.gru_cell(xs[:n, t], h[:n], *weights),
                               h[n:]])
                if ys is not None:
                    ys.append(h)
            if ys is not None:
                xs = torch.stack(ys, dim=1)
                if self.drop.active:
                    xs = self._drop_between(xs, mask, rows, steps)
        return run, h[rank]

    def _drop_between(self, xs: torch.Tensor, mask: torch.Tensor,
                      rows: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """The dropout between two layers on the runs ``xs [R, T, H]``,
        its mask drawn as ``[B, L, H]`` and each valid pulse's entry
        moved to its run and step."""
        keep = 1.0 - self.drop.rate

        def draw() -> torch.Tensor:
            drawn = stochastic.keep_mask(mask.shape + (self.hidden_size,),
                                         keep, xs.device)
            kept = torch.zeros(xs.shape, dtype=torch.bool, device=xs.device)
            kept[rows, steps] = drawn[mask]
            return kept

        return stochastic.apply_keep(xs, keep, draw)

    def forward(self, batch: EventBatch) -> EventBatch:
        x, mask = batch.x, batch.mask
        B, L, D = x.shape
        new_node = (x[..., -1] > 0.5) & mask
        charge_col = self.time_series_columns[0]
        ts = x[..., self.time_series_columns]
        if self.embedding_dim:
            ts = self.emb(ts * 4096.0).reshape(B, L, -1)
        run, states = self._run_states(ts, mask, new_node)

        # the sensors: segment s of an event runs from its s-th marker to
        # the next (pulses before the first marker join segment 0)
        seg = (torch.cumsum(new_node.long(), dim=1) - 1).clamp(0, L - 1)
        pos = torch.arange(L, device=x.device).expand(B, L)
        first = torch.full((B, L), L, device=x.device).scatter_reduce(
            1, seg, torch.where(mask, pos, L), "amin")
        last = torch.full((B, L), -1, device=x.device).scatter_reduce(
            1, seg, torch.where(mask, pos, -1), "amax")
        charge_sum = torch.zeros((B, L), dtype=x.dtype,
                                 device=x.device).scatter_add(
            1, seg, torch.where(mask, x[..., charge_col], 0.0))
        valid_dom = (first < L) & (last >= 0)
        first_c, last_c = first.clamp(0, L - 1), last.clamp(0, L - 1)
        dom_feats = torch.gather(x, 1, first_c[..., None].expand(B, L, D))
        dom_feats = dom_feats[..., :-1].clone()
        dom_feats[..., charge_col] = torch.asinh(charge_sum)
        if len(states):
            dom_run = torch.gather(run, 1, last_c).clamp(0, len(states) - 1)
            dom_state = states[dom_run]
        else:
            dom_state = x.new_zeros((B, L, self.hidden_size))
        nodes = torch.cat([dom_feats, dom_state], dim=-1)
        nodes = torch.where(valid_dom[..., None], nodes, 0.0)
        return dataclasses.replace(batch, x=nodes, mask=valid_dom, edges=None,
                                   edge_mask=None)
