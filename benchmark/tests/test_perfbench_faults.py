"""A run with its timed path broken underneath reads ``correct`` false,
once for each fault a cell can have (``tools/faults.py``): a step that
returns its state unchanged, half of the batch left out with the mean over
the rest, an answer altered where it is produced. No cell spans chips, so
none can leave out an exchange between them. Tiny sizes on the CPU, the
look for a card skipped; the limits are the cells' own."""

import pytest

from conftest import tiny_run
from tools.faults import FAULTS, planted

CASES = [(cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    run = tiny_run(cell)
    with planted(cell, fault):
        result = run.execute(1.0)
    assert not result["correct"], result["checks"]
