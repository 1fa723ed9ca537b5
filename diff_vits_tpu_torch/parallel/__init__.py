"""Parallelism of the port: data parallelism over ``torch.distributed``
(``mesh``) and the mixture-of-experts feed-forward (``moe``)."""
