"""System adapters, one per configuration `system`: the only code of the
benchmark that calls into `openfhe_tpu_torch`."""
