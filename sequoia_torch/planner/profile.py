"""Planner inputs.

Only the bundled acceptance vector is ported so far; the H100 latency
curve (`sequoia_tpu/planner/profile.py::time_forward_widths`,
`measure_latency_curve`) waits for a later slice.
"""

from __future__ import annotations

import json
import os

import numpy as np


def default_acceptance_vector() -> np.ndarray:
    """The bundled 68m->7b stochastic acceptance measurement (see JSON for
    provenance). The reference planner drops the trailing element
    (`tree_search.py:14`); so does this."""
    path = os.path.join(os.path.dirname(__file__), "acceptance_default.json")
    with open(path) as f:
        return np.asarray(json.load(f)["vector"], np.float64)[:-1]
