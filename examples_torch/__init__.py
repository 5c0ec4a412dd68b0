"""Examples of the PyTorch port (`openfhe_tpu_torch`), counterparts of
`examples/`. Each has a `main(device=None)` that runs on the GPU unless
asked for the CPU, and a `--device` flag:

    python examples_torch/simple_integers.py [--device cpu]
"""
