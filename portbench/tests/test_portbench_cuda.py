"""The check on the card at each cell's own size: sound runs are
correct, and the check's control comes out not correct on three seeds.
Run on the card with

    python3 -m pytest -q -p no:cacheprovider portbench/tests -m cuda
"""

import pytest

from portbench import harness
from portbench_cases import CELLS, SEED

CONTROL_SEEDS = (SEED + 101, SEED + 202, SEED + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_on_the_card(card, cell):
    result, code, lines = harness.run(cell, SEED + 1, 2.0, False,
                                      device=card)
    assert code == 0 and result["correct"], lines


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_control_is_not_correct_on_the_card(card, cell, seed):
    result, code, lines = harness.run(cell, seed, 2.0, False, device=card,
                                      control=True)
    assert code == 0 and not result["correct"], lines
    print(cell, seed, result["checks"])
