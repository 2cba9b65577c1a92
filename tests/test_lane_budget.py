"""The probe-lane budget comes from the device's memory: a 16 GB card
sub-batches the widest ladder rung, an 80 GB card keeps every rung at the
full 32,768-read batch, and the 150 bp rung (W=160) stays at 32,768 on
both."""

import pytest

from fulgor_tpu.query import engine as E

LADDER = (64, 96, 128, 160, 192, 256, 384, 512, 768, 1024)


@pytest.mark.parametrize("bytes_limit,batches", [
    (16 * 10**9, (32768,) * 9 + (31232,)),
    (80 * 10**9, (32768,) * 10),
])
def test_batch_per_ladder_width(bytes_limit, batches):
    assert E.WIDTH_LADDER == LADDER
    lanes = E.max_lanes(bytes_limit)
    got = tuple(E.batch_for_width(32768, W, 31, lanes) for W in LADDER)
    assert got == batches
    for W, B in zip(LADDER, got):
        assert B % 256 == 0 and B * (W - 31 + 1) <= lanes
