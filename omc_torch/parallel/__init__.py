"""Multi-process frontier distribution (``omc_torch.parallel.dist``), its
worker entry point (``python -m omc_torch.parallel.worker``), and the
node-batch split over devices (``omc_torch.parallel.mesh``)."""
