"""Run configuration: the reference's jax-free `SVIConfig`, re-exported.

The port runs the same hyperparameters and options as the reference, so
it shares the one dataclass rather than a copy that could drift.
Options the port does not run yet raise `NotImplementedError` where they
would take effect (svi/engine.py, svi/driver.py).
"""

from terastructure_tpu.config import SVIConfig  # noqa: F401
