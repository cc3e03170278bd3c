"""The profiling helper's interval arithmetic (dbde_tpu_torch.profile_paths),
on the CPU: device busy time is the union of activity intervals."""

import pytest

from dbde_tpu_torch.profile_paths import idle_share


@pytest.mark.parametrize("intervals, busy, span", [
    ([("k", 0.0, 10.0)], 10.0, 10.0),
    ([("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0)], 22.0, 30.0),  # overlap + gap
    ([("c", 20.0, 30.0), ("a", 0.0, 10.0), ("b", 2.0, 4.0)], 20.0, 30.0),  # unordered, nested
])
def test_idle_share_is_one_minus_union_over_span(intervals, busy, span):
    got_busy, got_span, idle = idle_share(intervals)
    assert (got_busy, got_span) == (busy, span)
    assert idle == 1.0 - busy / span
