"""YAML configs of models and datasets (counterpart of
``graphnet_tpu/utils/config.py``).

The same files as the JAX package's, read and written the same way
(PyYAML's ``safe_load`` / ``safe_dump``): a config is
``{class_name, arguments}``, nested components appear as
``{"__model__": {...}}`` and registered functions as
``{"__transform__": name}``.  Nothing in a file is executed.

* :class:`ModelConfig`: the serialisable description of a component tree;
* :data:`CLASS_REGISTRY` holds every class of this package a config may
  name; a name that is not there (a class of the JAX package that is not
  ported yet) raises ``KeyError`` naming it;
* :data:`TRANSFORM_REGISTRY` the named target and prediction transforms,
  in torch;
* :func:`save_config` captures a constructor's arguments, so that
  :func:`capture_config` of a built model gives the dict that the JAX
  package's flax fields give;
* :func:`build`, :func:`load_model`, :func:`save_model`: models to and
  from files.  A :class:`StandardModel` is built with its backbone first:
  each task gets ``hidden_size=backbone.nb_outputs`` (the JAX package's
  flax tasks infer it, so no file carries it), and ``seed`` and
  ``device`` come from :func:`load_model`'s keywords.  ``save_model``
  writes the JAX package's ``config.yml`` + ``state_dict.pkl`` layout
  (the pickle holds the JAX-layout parameter tree), so each package
  loads the other's saved models.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import yaml

CLASS_REGISTRY: Dict[str, type] = {}
TRANSFORM_REGISTRY: Dict[str, Callable] = {}


def register_class(cls: type, name: Optional[str] = None) -> type:
    CLASS_REGISTRY[name or cls.__name__] = cls
    return cls


def register_transform(name: str, fn: Callable) -> None:
    TRANSFORM_REGISTRY[name] = fn
    setattr(fn, "_config_name", name)


register_transform("log10", lambda x: torch.log10(x))
register_transform("pow10", lambda x: torch.pow(10.0, x))
register_transform("log", lambda x: torch.log(x))
register_transform("exp", lambda x: torch.exp(x))
register_transform("identity", lambda x: x)
register_transform("cosh", lambda x: torch.cosh(x))
register_transform("arccosh", lambda x: torch.arccosh(x))
register_transform("log10_half", lambda x: torch.log10(x) / 2.0)
register_transform("pow10_double", lambda x: torch.pow(10.0, 2.0 * x))
register_transform("softmax", lambda x: torch.softmax(x, dim=-1))


def _register_framework_classes() -> None:
    """Fill the class registry with every class of the port's modules
    that a config may name."""
    import graphnet_tpu_torch.data.dataset as dataset_mod
    import graphnet_tpu_torch.models.detector.icecube  # noqa: F401
    import graphnet_tpu_torch.models.detector.liquido  # noqa: F401
    import graphnet_tpu_torch.data.parquet_dataset as parquet_dataset
    import graphnet_tpu_torch.data.sqlite_dataset as sqlite_dataset
    import graphnet_tpu_torch.models.graphs.edges as edges
    import graphnet_tpu_torch.models.graphs.graph_definition as graph_definition
    import graphnet_tpu_torch.models.graphs.graphs as graphs
    import graphnet_tpu_torch.models.graphs.nodes as nodes
    import graphnet_tpu_torch.models.gnn.convnet as convnet
    import graphnet_tpu_torch.models.gnn.dynedge as dynedge
    import graphnet_tpu_torch.models.gnn.dynedge_jinst as jinst
    import graphnet_tpu_torch.models.gnn.dynedge_kaggle_tito as tito
    import graphnet_tpu_torch.models.gnn.icemix as icemix
    import graphnet_tpu_torch.models.gnn.particlenet as particlenet
    import graphnet_tpu_torch.models.gnn.rnn_tito as rnn_tito
    import graphnet_tpu_torch.models.rnn.node_rnn as node_rnn
    import graphnet_tpu_torch.models.standard_model as sm
    import graphnet_tpu_torch.models.task.classification as cls_tasks
    import graphnet_tpu_torch.models.task.reconstruction as rec_tasks
    import graphnet_tpu_torch.models.task.task as task_base
    import graphnet_tpu_torch.models.transformer.iseecube as iseecube
    import graphnet_tpu_torch.training.labels as labels
    import graphnet_tpu_torch.training.loss_functions as losses
    from graphnet_tpu_torch.models.detector.detector import _DETECTOR_REGISTRY
    from graphnet_tpu_torch.models.detector.prometheus import Prometheus

    for mod in (graphs, graph_definition, nodes, edges, convnet, dynedge,
                jinst, tito, icemix, particlenet, rnn_tito, node_rnn,
                iseecube, sm, cls_tasks, rec_tasks, task_base, losses,
                dataset_mod, sqlite_dataset, parquet_dataset, labels):
        for name, obj in vars(mod).items():
            if inspect.isclass(obj) and obj.__module__ == mod.__name__:
                register_class(obj, name)
    for name, cls in _DETECTOR_REGISTRY.items():
        register_class(cls, name)
    # the alias of ORCA150SuperDense that the reference's examples use
    register_class(Prometheus, "Prometheus")
    # GraphNeT's class name of RNNTITO, as its configs write it
    register_class(rnn_tito.RNNTITO, "RNN_TITO")


def _lookup(class_name: str) -> type:
    if class_name not in CLASS_REGISTRY:
        _register_framework_classes()
    if class_name not in CLASS_REGISTRY:
        raise KeyError(
            f"{class_name!r} is not a class of graphnet_tpu_torch: it is not "
            "ported yet, so a config that names it cannot be built"
        )
    return CLASS_REGISTRY[class_name]


@dataclasses.dataclass
class ModelConfig:
    """Serialisable description of a component tree."""

    class_name: str
    arguments: Dict[str, Any]

    def as_dict(self) -> Dict[str, Any]:
        return {"class_name": self.class_name,
                "arguments": _encode(self.arguments)}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.as_dict(), f, sort_keys=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return cls(class_name=d["class_name"], arguments=d["arguments"])

    @classmethod
    def load(cls, path: str) -> "ModelConfig":
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def _encode(value: Any) -> Any:
    """Python values as YAML-safe structures."""
    if value is None or isinstance(value, (str, bool)):
        return value
    if isinstance(value, (np.integer, int)):
        return int(value)
    if isinstance(value, (np.floating, float)):
        return float(value)
    if isinstance(value, ModelConfig):
        return {"__model__": value.as_dict()}
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if inspect.isfunction(value) or inspect.isbuiltin(value):
        name = getattr(value, "_config_name", None)
        if name is None:
            raise ValueError(
                f"Cannot serialise unregistered callable {value!r}; "
                "register it with register_transform()."
            )
        return {"__transform__": name}
    # any other object is a nested component
    return {"__model__": capture_config(value).as_dict()}


def _decode(value: Any) -> Any:
    if isinstance(value, dict):
        if "__model__" in value:
            return build(ModelConfig.from_dict(value["__model__"]))
        if "__transform__" in value:
            return TRANSFORM_REGISTRY[value["__transform__"]]
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def capture_config(obj: Any) -> ModelConfig:
    """The ModelConfig of an object: the arguments its constructor
    captured (:func:`save_config`), a dataclass's fields, or none for a
    class whose constructor takes no arguments."""
    if hasattr(obj, "_captured_config"):
        return obj._captured_config
    if dataclasses.is_dataclass(obj):
        return ModelConfig(
            class_name=type(obj).__name__,
            arguments={f.name: getattr(obj, f.name)
                       for f in dataclasses.fields(obj)},
        )
    init = type(obj).__init__
    if init is object.__init__ or list(inspect.signature(init).parameters) == [
            "self"]:
        return ModelConfig(class_name=type(obj).__name__, arguments={})
    raise TypeError(
        f"Cannot capture config of {type(obj).__name__}; use @save_config."
    )


def save_config(init: Optional[Callable] = None, *, ignore=()) -> Callable:
    """Decorator for ``__init__``: capture the arguments, defaults filled
    in, into ``self._captured_config``.  ``ignore`` names arguments that
    are not part of the model's description (a task's ``hidden_size``,
    which :func:`build` supplies; a model's ``seed`` and ``device``).
    The first capture wins: a subclass constructor that delegates to a
    decorated base constructor keeps its own arguments."""
    if init is None:
        return functools.partial(save_config, ignore=tuple(ignore))
    sig = inspect.signature(init)

    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs)
        bound.apply_defaults()
        captured = {k: v for k, v in bound.arguments.items()
                    if k != "self" and k not in ignore}
        captured.update(captured.pop("kwargs", {}))
        if not hasattr(self, "_captured_config"):
            self._captured_config = ModelConfig(
                class_name=type(self).__name__, arguments=captured)
        return init(self, *args, **kwargs)

    return wrapper


def build(config: ModelConfig, **kwargs: Any) -> Any:
    """Instantiate a component tree from a config; ``kwargs`` are further
    constructor arguments of the top-level object."""
    from graphnet_tpu_torch.models.standard_model import StandardModel

    cls = _lookup(config.class_name)
    if issubclass(cls, StandardModel):
        return _build_standard_model(cls, config.arguments, **kwargs)
    args = {k: _decode(v) for k, v in config.arguments.items()}
    return cls(**args, **kwargs)


def _build_standard_model(cls: type, arguments: Dict[str, Any],
                          **kwargs: Any) -> Any:
    """The backbone first, then each task with the backbone's width as
    its ``hidden_size``."""
    args = dict(arguments)
    backbone = _decode(args.pop("backbone"))
    tasks = []
    for task in args.pop("tasks"):
        if not (isinstance(task, dict) and "__model__" in task):
            raise ValueError(f"a task must be a nested component; got {task!r}")
        tasks.append(build(ModelConfig.from_dict(task["__model__"]),
                           hidden_size=backbone.nb_outputs))
    rest = {k: _decode(v) for k, v in args.items()}
    return cls(backbone=backbone, tasks=tasks, **rest, **kwargs)


def save_model_config(model: Any, path: str) -> None:
    capture_config(model).dump(path)


def load_model(path: str, device="cuda", seed: int = 0) -> Any:
    """Build the model of a ``model.yml``.  A :class:`StandardModel` gets
    its parameters initialised from ``seed`` and lives on ``device`` (the
    GPU unless the caller asks for the CPU); other components are built
    as the file says."""
    from graphnet_tpu_torch.models.standard_model import StandardModel

    config = ModelConfig.load(path)
    if issubclass(_lookup(config.class_name), StandardModel):
        return build(config, seed=seed, device=device)
    return build(config)


def save_model(model: Any, directory: str) -> None:
    """Save a port model as ``config.yml`` + ``state_dict.pkl`` in
    ``directory``: the JAX package's layout, the pickle a JAX-layout
    parameter tree (``{"params": ...}`` of float32 numpy arrays)."""
    from graphnet_tpu_torch.utils.jax_params import params_to_jax

    os.makedirs(directory, exist_ok=True)
    save_model_config(model, os.path.join(directory, "config.yml"))
    with open(os.path.join(directory, "state_dict.pkl"), "wb") as f:
        pickle.dump(params_to_jax(model.state_dict()), f)


def load_saved_model(directory: str, device="cuda", seed: int = 0) -> Any:
    """The model that :func:`save_model` (of either package) saved in
    ``directory``, its weights loaded (unpickling runs code: load only
    directories of known origin)."""
    from graphnet_tpu_torch.utils.jax_params import load_jax_state_dict

    model = load_model(os.path.join(directory, "config.yml"), device, seed)
    model.load_state_dict(load_jax_state_dict(
        os.path.join(directory, "state_dict.pkl"), model.state_dict()))
    return model


# ------------------------------------------------------------ datasets
def save_dataset_config(dataset: Any, path: str) -> None:
    """Dump a dataset (its constructor arguments, with the nested graph
    definition) to YAML."""
    capture_config(dataset).dump(path)


def load_dataset(path: str) -> Any:
    """The dataset(s) of a dataset-config YAML: a plain selection gives
    one Dataset; ``selection: {name: sel}`` gives ``{name: Dataset}``;
    ``selection: {name: [sel, sel, ...]}`` gives ``{name:
    EnsembleDataset}``."""
    cfg = ModelConfig.load(path)
    selection = cfg.arguments.get("selection")
    if isinstance(selection, dict):
        return {name: _build_dataset_with_selection(cfg, sel)
                for name, sel in selection.items()}
    return build(cfg)


def _build_dataset_with_selection(cfg: ModelConfig, selection: Any) -> Any:
    from graphnet_tpu_torch.data.dataset import EnsembleDataset

    def one(sel):
        return build(ModelConfig(class_name=cfg.class_name,
                                 arguments={**cfg.arguments, "selection": sel}))

    # a list of per-dataset selections (each a string or an id list) is
    # an ensemble; a flat list of event ids is one selection
    if (isinstance(selection, list) and selection
            and isinstance(selection[0], (list, str))):
        return EnsembleDataset([one(s) for s in selection])
    return one(selection)


@dataclasses.dataclass
class TrainingConfig:
    """Training hyper-parameters as data: target(s), early stopping,
    ``Trainer.fit`` and DataLoader keywords."""

    target: Any
    early_stopping_patience: int = 5
    fit: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dataloader: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "TrainingConfig":
        with open(path) as f:
            return cls(**yaml.safe_load(f))
