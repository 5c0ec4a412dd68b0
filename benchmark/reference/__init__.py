"""The benchmark's plain reference: the same operations as the port's timed
paths in plain PyTorch int64, written from their definitions. It imports
neither `jax`, nor `openfhe_tpu`, nor anything of `openfhe_tpu_torch`, and
works out every table it uses (roots of unity, CRT constants, keys) from
the configuration and the benchmark's own inputs."""
