from raptor_tpu_torch.parallel.comm import Ring, spawn

__all__ = ["Ring", "spawn"]
