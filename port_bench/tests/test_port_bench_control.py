"""The control on the card, at each one-chip cell's own size: the plain
reference with float8 e4m3 operands (the step below the configurations'
bfloat16), put in the program's place, has to come out as not correct
against the cell's limits, on three seeds.  Skips without a card."""

import pytest
import torch.distributed as dist

from port_bench import check, harness, reference, spec

SEEDS = (3100000001, 3100000002, 3100000003)


@pytest.mark.chip
@pytest.mark.parametrize("name", ["gpt2m-blockq-b16x1024",
                                  "r18-blockq-b2048"])
def test_control_is_not_correct(card, name):
    cell = spec.load_cell(name)
    reference.tf32_off()
    for seed in SEEDS:
        st = harness.prepare(cell, seed, card)
        harness.free(st)
        ref = harness.reference_readings(st)
        control = harness.reference_readings(st, precision="fp8")
        ok, compared = check.judge(check.readings(control, ref), cell.limits)
        assert not ok, (seed, compared)
    dist.destroy_process_group()
