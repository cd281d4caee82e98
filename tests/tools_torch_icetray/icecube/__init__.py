"""A test stand-in for the IceCube software stack (IceTray): only the
names that the port's and the JAX package's IceTray modules touch, in
plain Python.  It is importable as ``icecube`` only where its directory,
``tests/tools_torch_icetray``, is put on ``sys.path`` (the tests'
``icetray`` fixture, ``chip_smoke.py``'s serve_i3 phase).  Its ``.i3``
files are pickled lists of frames, not IceTray's format."""
