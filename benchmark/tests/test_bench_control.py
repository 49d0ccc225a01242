"""The control of each cell comes out not correct: the plain reference put
in the program's place and computed one precision below the
configuration's (a bf16 chain: float8 operands and a bf16 flow; float32:
TF32), judged by the cell's own numbers and limits.

On the CPU the float8 controls run at a small size. The card tests run
every cell's control at the cell's own size on three seeds
(``python3 -m pytest benchmark/tests -m card``); they also hold the
program's own readings under the limits there.
"""

import pytest
import torch

from benchmark import harness
from benchmark.readings import read

SPEC = harness.load_spec()
SMALL = {"dncnn17.finetune540": {"height": 48, "width": 64, "frames": 6,
                                 "warmup_frames": 2, "sample_within": 1},
         "dncnn17.serve1080": {"height": 32, "width": 48, "sample_within": 2,
                               "sample_calls": 2}}


def readings(cell, seed, device, overrides=None, seconds=0.5):
    return read(cell, seed, [device], seconds, True, overrides)


def above(numbers, limits):
    return [k for k in limits if numbers[k] > limits[k]]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_float8_control_fails_on_the_cpu(cell):
    _, control = readings(cell, 2**31 + 3, torch.device("cpu"), SMALL[cell])
    assert above(control, harness.limits_of(cell))


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**32 + 1, 2**32 + 2, 2**32 + 3])
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]
                                  if w["chips"] == 1])
def test_control_fails_and_program_passes_on_the_card(card, cell, seed):
    limits = harness.limits_of(cell)
    program, control = readings(cell, seed, card, seconds=12.0)
    assert above(control, limits)
    assert not above(program, limits)
