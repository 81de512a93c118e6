"""repro_torch.launch — mesh, dry run, roofline, training entry points.

``train`` is the training launcher (``python -m repro_torch.launch.train``)
and ``dryrun`` the production-mesh dry run (``python -m
repro_torch.launch.dryrun``), which counts each cell's step with
``op_cost`` and prices it with ``roofline``. ``dryrun`` is not imported
here, as in the JAX package: it is an entry point.
"""
from .mesh import make_production_mesh, make_test_mesh
from . import roofline

__all__ = ["make_production_mesh", "make_test_mesh", "roofline"]
