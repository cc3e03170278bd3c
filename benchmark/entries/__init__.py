"""The program's entries that a traffic file can name (``"entry"``).

Each module has ``prepare(run)``, ``warm(run)`` (set-up: one small file
of the last source frames written and read through the same calls, so
that an answer left over from it is wrong in the window), ``write_half(run, deadline)``
and ``read_half(run, deadline)``, and ``cards(run)``: the CUDA cards it
drives.
"""
