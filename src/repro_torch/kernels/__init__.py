"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it. Sources live under ``<kernel>/csrc/`` and are built at
first use by :mod:`repro_torch.kernels.build`. :mod:`repro_torch.kernels.products`
holds the float32-sum batched product that the models and the plain
versions share."""
