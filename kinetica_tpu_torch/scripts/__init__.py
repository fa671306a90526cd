"""Measurement scripts of the port, run on a machine with a CUDA card
(``python -m kinetica_tpu_torch.scripts.<name> --help``)."""
