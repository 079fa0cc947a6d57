"""A run with its timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program at a tiny size on the CPU,
against the cell's own limits. (No cell runs on more than one chip, so no
cell has an exchange between chips to leave out.)"""

from __future__ import annotations

import pytest

from benchmark.tests.tiny import numbers, tiny_run

CASES = [
    ("resnet50.train-market", "stale_state", "update_gap"),
    ("resnet50.train-market", "half_batch", "grad_gap"),
    ("resnet50.train-market", "altered_answer", "aug_gap"),
    ("resnet50.train-market", "stale_mining", "mining_pset_gap"),
    ("transreid_jpm.eval-market", "half_batch", "embed_gap"),
    ("transreid_jpm.eval-market", "altered_answer", "cmc_gap"),
]
_SOUND: dict = {}


def _sound(cell, tmp_path_factory):
    if cell not in _SOUND:
        _SOUND[cell] = numbers(tiny_run(cell, tmp_path_factory.mktemp("sound")))
    return _SOUND[cell]


@pytest.mark.parametrize("cell,fault,number", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, number, tmp_path_factory):
    broken = tiny_run(cell, tmp_path_factory.mktemp("broken"), fault=fault)
    assert not all(c.ok for c in broken.checks)
    got = numbers(broken)[number]
    assert got > broken.limit(number)
    assert got > 2 * _sound(cell, tmp_path_factory)[number]

