"""The benchmark harness of the PyTorch and CUDA port (``graphnet_tpu_torch``).

Everything that belongs to one configuration, traffic mix, model family,
metric or operator lives in a file of its own under ``benchmark/`` and is
found by the name ``BENCHMARK.json`` gives it (:mod:`.spec`).  The modules
here are the general parts: the traffic generator, the weight maker, the
set-up and window of a training or a reprocessing cell, the trace reader
and the check that decides ``correct``.
"""
