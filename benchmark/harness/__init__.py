"""The benchmark's harness: one closed loop for every cell, the
traffic generator, the profiler's reading and the frozen work counts. A
system adapter (`systems/<config's system>.py`) is the only code that
calls into `openfhe_tpu_torch`."""
