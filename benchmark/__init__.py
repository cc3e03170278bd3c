"""The benchmark of ``dbde_tpu_torch``, the PyTorch and CUDA DBDE codec.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout and prints one JSON line.  Everything that defines a cell is a
file found by name:

  * ``configs/<config>.json``: a deployment (sensor geometry, content
    model, batch, pipeline, file length, sink, guarantees);
  * ``workloads/<cell>.json``: the traffic mix, parameters that the entry
    it names (``entries/<entry>.py``) reads;
  * ``metrics/<metric>.json``: a per-layer metric, with the reader
    (``readers/<reader>.py``) that takes it from spans or the device trace.

The yardstick lives here and imports nothing of the measured program:
the seeded content (:mod:`.content`), the plain reference encoder
(:mod:`.reference`), the comparison that decides ``correct``
(:mod:`.checks`), the profiler's interval arithmetic (:mod:`.intervals`)
and the table of peaks (``peaks.json``).  The program is driven only
through its public file entries in :mod:`.entries`.
"""
