"""The printed rows of the figure twins: the reference benches' CSV line
``name,us,derived`` (``benchmarks/common.py::emit``), one per row, and
the same rows returned as a dict for callers that compare runs."""
from __future__ import annotations

from typing import Callable, Dict


def printer(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}", flush=True)


class Rows:
    """Ordered rows ``name -> {"us": ..., "derived": ..., **values}``;
    each ``add`` also hands the row to ``emit``."""

    def __init__(self, emit: Callable[[str, float, str], None] = printer):
        self.emit = emit
        self.rows: Dict[str, dict] = {}

    def add(self, name: str, us: float, derived: str, **values) -> None:
        self.rows[name] = dict(us=us, derived=derived, **values)
        self.emit(name, us, derived)
