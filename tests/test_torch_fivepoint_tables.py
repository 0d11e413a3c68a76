"""Kernel E's monomial tables against the twin's: csrc/fivepoint_body.cuh
holds literal copies of geometry/fivepoint.py's `_LL`, `_QL` and `_MON20`
(the kernel's unrolled loops index them with constants) and computes the
reduced rows of B(z) as 3 r + 3 and 3 r + 2; these must be the twin's."""

import re
from pathlib import Path

import numpy as np
import pytest

from cuda_surf_tpu_torch.geometry import fivepoint as tfp

BODY = Path(tfp.__file__).resolve().parents[1] / "csrc" / "fivepoint_body.cuh"


def _literal(name):
    """The numbers of `constexpr unsigned char <name>[..] = {...};`."""
    found = re.search(r"constexpr unsigned char %s\[[^=]*=\s*\{(.*?)\};"
                      % name, BODY.read_text(), re.S)
    assert found, name
    return [int(v) for v in re.findall(r"\d+", found.group(1))]


@pytest.mark.parametrize("name,table", [("LL", tfp._LL), ("QL", tfp._QL),
                                        ("MON20", tfp._MON20)])
def test_kernel_tables_are_the_twins(name, table):
    assert _literal(name) == np.asarray(table).ravel().tolist()


def test_kernel_bz_rows_are_the_twins():
    rows = [(tfp._ROW_X2, tfp._ROW_X2Z), (tfp._ROW_XY, tfp._ROW_XYZ),
            (tfp._ROW_Y2, tfp._ROW_Y2Z)]
    assert rows == [(3 * r + 3, 3 * r + 2) for r in range(3)]
    assert "sm.gs[3 * lane + 3]" in BODY.read_text()
    assert "sm.gs[3 * lane + 2]" in BODY.read_text()
