"""Resilience: seeded fault injection, drift watchdog, plan failover.

Counterpart of ``repro/resilience``.  Only ``faults`` is imported
eagerly: ``core.ccim`` imports it at load time, and ``failover`` imports
the scheduler (which imports core), so an eager import of the whole
package would cycle.  ``watchdog`` and ``failover`` resolve lazily on
first attribute access.
"""
from . import faults  # noqa: F401


def __getattr__(name):
    if name in ("watchdog", "failover"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
