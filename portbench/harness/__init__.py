"""The benchmark harness of the PyTorch/CUDA port: the manifest, the
traffic generator, the cells, the window, the probes around the program's
functions, the reading of the profiler's trace and the work of each
kernel.  Everything a cell, a traffic mix or a metric needs of its own
lives in a file found by its name (``configs/``, ``traffic/``,
``metrics/``, ``limits/``)."""
