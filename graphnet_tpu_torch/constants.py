"""Repository paths (counterpart of ``graphnet_tpu/constants.py``)."""

import os

GRAPHNET_ROOT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..")
)
DATA_DIR = os.environ.get(
    "GRAPHNET_DATA_DIR", os.path.join(GRAPHNET_ROOT_DIR, "data")
)
GEOMETRY_TABLE_DIR = os.path.join(DATA_DIR, "geometry_tables")
ICECUBE_GEOMETRY_TABLE_DIR = os.path.join(GEOMETRY_TABLE_DIR, "icecube")
PROMETHEUS_GEOMETRY_TABLE_DIR = os.path.join(GEOMETRY_TABLE_DIR, "prometheus")
LIQUIDO_GEOMETRY_TABLE_DIR = os.path.join(GEOMETRY_TABLE_DIR, "liquid-o")
ICE_PROPERTIES_DIR = os.path.join(DATA_DIR, "ice_properties")
EXAMPLE_DATA_DIR = os.path.join(DATA_DIR, "examples")
EXAMPLE_SQLITE_DATA = os.path.join(
    EXAMPLE_DATA_DIR, "sqlite", "prometheus", "prometheus-events.db"
)
EXAMPLE_PARQUET_DATA = os.path.join(
    EXAMPLE_DATA_DIR, "parquet", "prometheus", "merged"
)
CONFIG_DIR = os.path.join(GRAPHNET_ROOT_DIR, "configs")
PRETRAINED_MODEL_DIR = os.path.join(CONFIG_DIR, "models", "zoo")
