"""Helpers that build loaders and save results (counterpart of
``graphnet_tpu/training/utils.py``).

The datasets are SQLite for a ``.db`` path and Parquet otherwise; the
loaders are the port's length-matched :class:`~graphnet_tpu_torch.data.
dataloader.DataLoader`.  ``get_predictions`` and ``save_results`` need
pandas (imported by ``Trainer.predict_as_dataframe``).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from graphnet_tpu_torch.data.dataloader import DataLoader
from graphnet_tpu_torch.data.dataset import Dataset
from graphnet_tpu_torch.data.parquet_dataset import ParquetDataset
from graphnet_tpu_torch.data.sqlite_dataset import SQLiteDataset

logger = logging.getLogger(__name__)


def _make_dataset(
    db: Union[str, List[str]],
    graph_definition: Any,
    pulsemaps: Union[str, List[str]],
    features: List[str],
    truth: List[str],
    **kwargs: Any,
) -> Dataset:
    path = db[0] if isinstance(db, list) and len(db) == 1 else db
    first = path if isinstance(path, str) else path[0]
    cls = SQLiteDataset if str(first).endswith(".db") else ParquetDataset
    return cls(path=path, graph_definition=graph_definition,
               pulsemaps=pulsemaps, features=features, truth=truth, **kwargs)


def make_dataloader(
    db: Union[str, List[str]],
    pulsemaps: Union[str, List[str]],
    graph_definition: Any,
    features: List[str],
    truth: List[str],
    *,
    batch_size: int,
    shuffle: bool,
    selection: Optional[List[int]] = None,
    num_workers: int = 0,
    node_truth: Optional[List[str]] = None,
    truth_table: str = "truth",
    node_truth_table: Optional[str] = None,
    string_selection: Optional[List[int]] = None,
    loss_weight_table: Optional[str] = None,
    loss_weight_column: Optional[str] = None,
    index_column: str = "event_no",
    labels: Optional[Dict[str, Callable]] = None,
    seed: Optional[int] = None,
) -> DataLoader:
    """A :class:`DataLoader` over a SQLite or Parquet dataset, with the
    custom ``labels`` added to the dataset."""
    dataset = _make_dataset(
        db, graph_definition, pulsemaps, features, truth,
        selection=selection, node_truth=node_truth, truth_table=truth_table,
        node_truth_table=node_truth_table, string_selection=string_selection,
        loss_weight_table=loss_weight_table,
        loss_weight_column=loss_weight_column, index_column=index_column,
    )
    for name, fn in (labels or {}).items():
        dataset.add_label(fn, key=name)
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      seed=seed, num_workers=num_workers)


def make_train_validation_dataloader(
    db: Union[str, List[str]],
    graph_definition: Any,
    selection: Optional[List[int]],
    pulsemaps: Union[str, List[str]],
    features: List[str],
    truth: List[str],
    *,
    batch_size: int,
    database_indices: Optional[List[int]] = None,
    seed: int = 42,
    test_size: float = 0.33,
    num_workers: int = 0,
    node_truth: Optional[List[str]] = None,
    truth_table: str = "truth",
    node_truth_table: Optional[str] = None,
    string_selection: Optional[List[int]] = None,
    loss_weight_column: Optional[str] = None,
    loss_weight_table: Optional[str] = None,
    index_column: str = "event_no",
    labels: Optional[Dict[str, Callable]] = None,
) -> Tuple[DataLoader, DataLoader]:
    """A seeded train / validation pair of loaders: ``test_size`` of the
    selection (every event where it is None) goes to validation, by
    ``np.random.default_rng(seed).permutation``.  With several
    databases, ``selection`` pairs with ``database_indices`` into
    ``(event_no, db_index)`` tuples."""
    rng = np.random.default_rng(seed)
    if selection is None:
        dataset = _make_dataset(db, graph_definition, pulsemaps, features,
                                truth, truth_table=truth_table,
                                index_column=index_column)
        selection = dataset._get_all_indices()

    if isinstance(db, list) and len(db) > 1:
        if database_indices is None or len(database_indices) != len(selection):
            raise ValueError(
                "multi-database selections need matching `database_indices`")
        pairs = np.stack(
            [np.asarray(selection), np.asarray(database_indices)], axis=1)
        perm = rng.permutation(len(pairs))
        n_val = int(round(test_size * len(pairs)))
        val_sel = [tuple(p) for p in pairs[perm[:n_val]]]
        train_sel = [tuple(p) for p in pairs[perm[n_val:]]]
    else:
        sel = np.asarray(selection)
        perm = rng.permutation(len(sel))
        n_val = int(round(test_size * len(sel)))
        val_sel = sel[perm[:n_val]].tolist()
        train_sel = sel[perm[n_val:]].tolist()

    common = dict(
        db=db, pulsemaps=pulsemaps, graph_definition=graph_definition,
        features=features, truth=truth, batch_size=batch_size,
        num_workers=num_workers, node_truth=node_truth,
        truth_table=truth_table, node_truth_table=node_truth_table,
        string_selection=string_selection,
        loss_weight_column=loss_weight_column,
        loss_weight_table=loss_weight_table, index_column=index_column,
        labels=labels,
    )
    train_loader = make_dataloader(shuffle=True, selection=train_sel,
                                   seed=seed, **common)
    val_loader = make_dataloader(shuffle=False, selection=val_sel, **common)
    return train_loader, val_loader


def get_predictions(
    trainer: Any,
    dataloader: DataLoader,
    prediction_columns: Optional[List[str]] = None,
    *,
    node_level: bool = False,
    additional_attributes: Optional[List[str]] = None,
):
    """Predictions and attributes as a pandas DataFrame
    (``Trainer.predict_as_dataframe``, which also repeats event
    attributes per pulse for node-level tasks), the prediction columns
    renamed to ``prediction_columns`` where given."""
    df = trainer.predict_as_dataframe(
        dataloader, additional_attributes=additional_attributes)
    if prediction_columns is not None:
        df = df.rename(columns=dict(
            zip(trainer.model.prediction_labels, prediction_columns)))
    return df


def save_results(
    db: str, tag: str, results: Any, archive: str, trainer: Any
) -> None:
    """The results table as ``results.csv`` and the model as
    ``model.yml`` + ``state_dict.pkl`` under ``archive/<db name>/<tag>/``."""
    db_name = os.path.basename(db).split(".")[0]
    path = os.path.join(archive, db_name, tag)
    os.makedirs(path, exist_ok=True)
    results.to_csv(os.path.join(path, "results.csv"))
    trainer.save_model(path)
    logger.info("Results saved at:\n %s", path)


def save_selection(selection: List[int], file_path: str) -> None:
    """A selection as one CSV line."""
    if not isinstance(selection, list):
        raise TypeError("Selection should be a list of integers.")
    with open(file_path, "w") as f:
        f.write(",".join(map(str, selection)))
        f.write("\n")
