"""The benchmark of the PyTorch/CUDA port (`pytorch_ps_mpi_tpu_torch`).

One run is one cell of ``BENCHMARK.json`` once::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one model family, configuration, traffic mix,
cell or metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py``, and for the model
family a configuration's ``model`` names, ``families/<model>.py`` with its
plain reference ``reference/<model>.py``.  The yardstick (the generators,
the plain reference in ``reference/``, the operation and byte counts, the
table of peaks and the comparison that decides ``correct``) lives here
too, so that a change to the program cannot move it.  Nothing here imports JAX, the JAX
package, or, under ``reference/``, anything of the port.
"""
