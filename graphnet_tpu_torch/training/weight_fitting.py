"""Per-event weight fitting (counterpart of ``graphnet_tpu/training/
weight_fitting.py``): weights that flatten (or reshape) a truth
variable's spectrum, optionally written back to the SQLite database as a
table of their own, which ``SQLiteDataset(loss_weight_table=...,
loss_weight_column=...)`` then reads.

numpy and ``sqlite3`` only (the GPU host has no pandas): a weight table
is a dict of columns, ``{index_column, variable, weight_name}`` each a
1-D numpy array in ascending order of the index (``pandas.DataFrame(
table)`` is the JAX package's frame), and
:func:`create_table_and_save_to_sql` writes the rows that ``pandas.
DataFrame.to_sql`` writes.
"""

from __future__ import annotations

import logging
import sqlite3
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np

logger = logging.getLogger(__name__)

Table = Dict[str, np.ndarray]


def _sql_type(values: np.ndarray) -> str:
    if values.dtype.kind in "iub":
        return "INTEGER"
    if values.dtype.kind == "f":
        return "REAL"
    return "TEXT"


def _py(v: Any) -> Any:
    """A numpy scalar as the Python value sqlite3 stores."""
    return v.item() if isinstance(v, np.generic) else v


def create_table_and_save_to_sql(
    df: Mapping[str, Any], table_name: str, database_path: str,
    index_column: str = "event_no",
) -> None:
    """Write the columns of ``df`` (a dict of 1-D arrays, or a DataFrame)
    to the database as the table ``table_name``, replacing one of that
    name, with an index on ``index_column``."""
    columns = list(df.keys())
    arrays = [np.asarray(df[c]) for c in columns]
    spec = ", ".join(f'"{c}" {_sql_type(a)}' for c, a in zip(columns, arrays))
    marks = ", ".join("?" * len(columns))
    with sqlite3.connect(database_path) as con:
        con.execute(f'DROP TABLE IF EXISTS "{table_name}"')
        con.execute(f'CREATE TABLE "{table_name}" ({spec})')
        con.executemany(
            f'INSERT INTO "{table_name}" VALUES ({marks})',
            ([_py(v) for v in row] for row in zip(*arrays)))
        con.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{table_name}_{index_column} "
            f"ON {table_name} ({index_column})")


def _sorted(table: Table, key: str) -> Table:
    order = np.argsort(table[key], kind="stable")
    return {name: col[order] for name, col in table.items()}


class WeightFitter:
    """Base: fit per-event weights from a truth variable's histogram."""

    def __init__(
        self,
        database_path: str,
        truth_table: str = "truth",
        index_column: str = "event_no",
    ):
        self._database_path = database_path
        self._truth_table = truth_table
        self._index_column = index_column
        self._max_weight: Optional[float] = None

    def _get_truth(
        self, variable: str, selection: Optional[List[int]] = None
    ) -> Table:
        q = f"select {self._index_column}, {variable} from {self._truth_table}"
        if selection is not None:
            q += f" where {self._index_column} in {tuple(selection)}"
        with sqlite3.connect(self._database_path) as con:
            rows = con.execute(q).fetchall()
        index = np.asarray([r[0] for r in rows], dtype=np.int64)
        values = np.asarray([r[1] for r in rows])
        return {self._index_column: index, variable: values}

    def fit(
        self,
        bins,
        variable: str,
        weight_name: Optional[str] = None,
        add_to_database: bool = False,
        selection: Optional[List[int]] = None,
        transform: Optional[Callable] = None,
        db_count_norm: Optional[int] = None,
        automatic_log_bins: bool = False,
        max_weight: Optional[float] = None,
        **kwargs: Any,
    ) -> Table:
        """The weights of ``variable`` (after ``transform``) over
        ``bins``: a table of the index, the variable and the weights,
        written to the database as the table ``weight_name`` if
        ``add_to_database``.  ``max_weight`` caps each weight at that
        share of their sum; ``db_count_norm`` scales them to that sum."""
        self._variable = variable
        self._bins = bins
        if max_weight is not None and not 0 < max_weight < 1:
            raise ValueError(f"max_weight must lie in (0, 1); got {max_weight}")
        self._max_weight = max_weight
        self._weight_name = weight_name or self._generate_weight_name()

        truth = self._get_truth(variable, selection)
        if transform is not None:
            truth[variable] = np.asarray(transform(truth[variable]))
        if automatic_log_bins:
            if not isinstance(bins, int):
                raise ValueError("automatic_log_bins takes a number of bins")
            self._bins = np.logspace(
                np.log10(truth[variable].min()),
                np.log10(truth[variable].max() + 1), bins)

        weights = self._fit_weights(truth, **kwargs)
        w = self._weight_name
        if self._max_weight is not None:
            cap = np.nansum(weights[w]) * self._max_weight
            weights[w] = np.minimum(weights[w], cap)
        if db_count_norm is not None:
            weights[w] = weights[w] * (db_count_norm / np.nansum(weights[w]))
        if add_to_database:
            create_table_and_save_to_sql(
                {self._index_column: weights[self._index_column], w: weights[w]},
                w, self._database_path, self._index_column)
            logger.info("weights written to table %r of %s", w,
                        self._database_path)
        return _sorted(weights, self._index_column)

    def _fit_weights(self, truth: Table, **kwargs) -> Table:
        raise NotImplementedError

    def _generate_weight_name(self) -> str:
        raise NotImplementedError

    def _uniform_sample_weights(self, truth: Table) -> np.ndarray:
        values = truth[self._variable]
        bin_counts, _ = np.histogram(values, bins=self._bins)
        bin_weights = 1.0 / np.where(bin_counts == 0, np.nan, bin_counts)
        ix = np.clip(np.digitize(values, bins=self._bins) - 1, 0,
                     len(bin_weights) - 1)
        w = bin_weights[ix]
        return w / np.nanmean(w)


class Uniform(WeightFitter):
    """Weights that flatten the variable's spectrum over the bins."""

    def _fit_weights(self, truth: Table) -> Table:
        truth[self._weight_name] = self._uniform_sample_weights(truth)
        return _sorted(truth, self._index_column)

    def _generate_weight_name(self) -> str:
        return self._variable + "_uniform_weight"


class BjoernLow(WeightFitter):
    """Uniform below ``x_low`` (or below that quantile with
    ``percentile``), ``1 / (1 + alpha (x - x_low))`` above, scaled so the
    two meet."""

    def _fit_weights(
        self,
        truth: Table,
        x_low: float,
        alpha: float = 0.05,
        percentile: bool = False,
    ) -> Table:
        values = truth[self._variable]
        w = self._uniform_sample_weights(truth)
        c = np.nanmax(np.histogram(values, bins=self._bins, weights=w)[0])
        if percentile:
            if not 0 < x_low < 1:
                raise ValueError(f"a percentile x_low lies in (0, 1); got {x_low}")
            x_low = np.quantile(values, x_low)
        above = values > x_low
        w[above] = 1.0 / (1.0 + alpha * (values[above] - x_low))
        d = np.nanmax(np.histogram(values, bins=self._bins, weights=w)[0])
        w[above] *= c / d
        truth[self._weight_name] = w
        return _sorted(truth, self._index_column)

    def _generate_weight_name(self) -> str:
        return self._variable + "_bjoern_low_weight"
