"""Point-sharded bundle adjustment over torch.distributed ranks
(parallel/sharding.py)."""
