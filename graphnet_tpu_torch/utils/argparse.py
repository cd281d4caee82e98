"""An ``argparse.ArgumentParser`` with GraphNeT's standard training
arguments (counterpart of ``graphnet_tpu/utils/argparse.py``)."""

from __future__ import annotations

import argparse
from typing import Any, Dict, Tuple, Union

OptionSpec = Union[str, Tuple[str, Any]]


class Options:
    """Named options, each a name or a ``(name, default)`` pair."""

    def __init__(self, *options: OptionSpec):
        self._options = list(options)

    def contains(self, name: str) -> bool:
        return any(self._name(o) == name for o in self._options)

    def pop_default(self, name: str) -> Any:
        for o in self._options:
            if self._name(o) == name:
                return o[1] if isinstance(o, tuple) else None
        raise KeyError(name)

    @staticmethod
    def _name(o: OptionSpec) -> str:
        return o[0] if isinstance(o, tuple) else o


STANDARD_ARGUMENTS: Dict[str, Dict[str, Any]] = {
    "path": dict(type=str, help="Path to dataset file(s)"),
    "pulsemap": dict(type=str, default="total", help="Pulse map name"),
    "target": dict(type=str, help="Name of the target variable"),
    "truth-table": dict(type=str, default="truth",
                        help="Name of truth table"),
    "chips": dict(nargs="*", type=int, default=None,
                  help="Accelerators to use"),
    "max-epochs": dict(type=int, default=5, help="Max training epochs"),
    "early-stopping-patience": dict(
        type=int, default=5, help="Early stopping patience (epochs)"),
    "batch-size": dict(type=int, default=128, help="Batch size"),
    "num-workers": dict(type=int, default=10, help="Dataloader workers"),
    "learning-rate": dict(type=float, default=1e-3, help="Peak LR"),
}


class ArgumentParser(argparse.ArgumentParser):
    """argparse with the registry of standard training arguments."""

    standard_arguments = STANDARD_ARGUMENTS

    def with_standard_arguments(self, *args: OptionSpec) -> "ArgumentParser":
        """Add ``--name`` for each standard argument named, a ``(name,
        default)`` pair overriding its default."""
        for arg in args:
            name, default = arg if isinstance(arg, tuple) else (arg, None)
            if name not in self.standard_arguments:
                raise KeyError(f"unknown standard argument {name!r}")
            spec = dict(self.standard_arguments[name])
            if default is not None:
                spec["default"] = default
            self.add_argument(f"--{name}", **spec)
        return self
