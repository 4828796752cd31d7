"""Data parallelism over torch.distributed: one process per card, the
episode meta-batch split over the processes, the gradients and loss
statistics summed (``mesh.py``), started from the ``FEWSHOT_*`` variables
(``distributed.py``)."""
