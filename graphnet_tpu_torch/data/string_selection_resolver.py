"""String-based event selections (counterpart of
``graphnet_tpu/data/string_selection_resolver.py``).

Supported forms (pandas ``DataFrame.query`` syntax for the filter part;
pandas is imported inside :meth:`StringSelectionResolver.resolve`):
  * ``"event_no % 5 > 0"``
  * ``"10000 random events ~ abs(pid) == 12"``
  * ``"20% random events ~ event_no % 5 == 0"``
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np


_RANDOM_RE = re.compile(
    r"^\s*(?P<amount>[\d.]+)\s*(?P<pct>%)?\s*random events\s*~\s*"
    r"(?P<query>.*)$"
)
_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_FUNCS = {"abs", "and", "or", "not", "in", "True", "False"}


class StringSelectionResolver:
    """Resolve a selection string to a list of event indices."""

    def __init__(
        self,
        dataset,
        index_column: str = "event_no",
        seed: Optional[int] = None,
    ):
        self._dataset = dataset
        self._index_column = index_column
        self._seed = seed

    def _variables_in(self, query: str) -> List[str]:
        return sorted(
            {
                m.group(0)
                for m in _IDENT_RE.finditer(query)
                if m.group(0) not in _FUNCS
            }
        )

    def resolve(self, selection: str) -> List[int]:
        import pandas as pd

        m = _RANDOM_RE.match(selection)
        if m:
            query: Optional[str] = m.group("query").strip() or None
            amount = float(m.group("amount"))
            is_pct = m.group("pct") is not None
        else:
            query, amount, is_pct = selection.strip(), None, False

        variables = (
            self._variables_in(query) if query else [self._index_column]
        )
        if self._index_column not in variables:
            variables = [self._index_column] + variables
        values = self._dataset.query_table(
            self._dataset.truth_table, variables
        )
        df = pd.DataFrame(np.asarray(values), columns=variables)
        if query:
            df = df.query(query)
        indices = df[self._index_column].astype(np.int64).to_numpy()

        if amount is not None:
            rng = np.random.default_rng(self._seed)
            n = (
                int(round(amount / 100.0 * len(indices)))
                if is_pct
                else min(int(amount), len(indices))
            )
            indices = rng.permutation(indices)[:n]
        return [int(i) for i in indices]
