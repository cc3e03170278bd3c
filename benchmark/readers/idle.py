"""The share of a half's traced wall time in which the card ran no kernel
and no copy, in %, the mean over the cards the cell drives."""

from ..intervals import busy


def read(trace, spec):
    half = trace.halves[spec["half"]]
    span = half["t1"] - half["t0"]
    if not trace.cards or span <= 0:
        return None
    ivs = trace.in_half(spec["half"])
    shares = [1.0 - busy([iv for iv in ivs if iv[0] == card]) / span for card in trace.cards]
    return 100.0 * sum(shares) / len(shares)
