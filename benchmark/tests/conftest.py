"""Fixtures of the benchmark's CPU tests: a checkout with tiny cells added
as files only (``portbench_tiny.make_root``), made once a session."""

import pytest

import portbench_tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return portbench_tiny.make_root(tmp_path_factory.mktemp("portbench"))
