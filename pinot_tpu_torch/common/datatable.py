"""The piece of pinot_tpu/common/datatable.py the combine layer needs.

This slice runs in one process, so it has no DataTable wire format yet.
"""
from __future__ import annotations

import numpy as np


def _col_to_list(col) -> list:
    if isinstance(col, np.ndarray):
        return col.tolist()
    return list(col)
