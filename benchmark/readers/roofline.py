"""A half's share of its memory roofline, in %: the least time its
batches' bytes need at the card's peak bandwidth (``peaks.json``) over the
kernel time the profiler saw in that half, copies left out, summed over
the cards.  The bytes (``trace.halves[half]["bytes"]``) count each input
byte read once and each output byte written once, from the frames' shapes
and the reference's encoded sizes, whatever kernels do the work."""

from ..intervals import is_copy


def read(trace, spec):
    half = trace.halves[spec["half"]]
    kernel_us = sum(e - s for _, name, s, e in trace.in_half(spec["half"]) if not is_copy(name))
    if kernel_us <= 0 or not half["bytes"]:
        return None
    least_s = half["bytes"] / trace.peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (kernel_us * 1e-6)
