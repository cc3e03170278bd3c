"""Host ms a batch in one callable of the program: ``spec["target"]``
(``module:attribute``), wrapped for the window, summed over the half
``spec["half"]`` and divided by the batches of that half."""


def read(trace, spec):
    half = trace.halves[spec["half"]]
    seconds, calls = half["spans"].get(spec["target"], (0.0, 0))
    if not calls or not half["batches"]:
        return None
    return 1e3 * seconds / half["batches"]
