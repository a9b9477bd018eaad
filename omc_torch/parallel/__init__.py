"""Multi-process frontier distribution (``omc_torch.parallel.dist``) and its
worker entry point (``python -m omc_torch.parallel.worker``)."""
