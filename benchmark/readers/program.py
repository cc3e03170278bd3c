"""Host ms a batch from the program's own spans and counters
(``dbde_tpu_torch.trace``, recorded while the traced run's profiler
records): the spans' total seconds (``spec["kind"]`` "span") or the
counters' values ("counter") of ``spec["names"]`` under the roots
``spec["roots"]`` (default: the write roots), summed, times
``spec["scale"]`` (ms a unit) and divided by the batches of the half
``spec["half"]``.  0.0 where some root recorded and none of the names did;
None where no root recorded, as on a program without the spans."""

FIELDS = {"span": "total_s", "counter": "value"}


def read(trace, spec):
    try:
        from dbde_tpu_torch import trace as program
    except ImportError:
        return None
    roots = spec.get("roots", program.WRITE_ROOTS)
    field = FIELDS[spec["kind"]]
    mine = [(name, entry) for (root, name), entry in program.totals().items() if root in roots]
    batches = trace.halves[spec["half"]]["batches"]
    if not mine or not batches:
        return None
    return spec["scale"] * sum(e[field] for name, e in mine if name in spec["names"]) / batches
