from raptor_tpu_torch.solve.krylov import KrylovInfo, krylov_dispatch, pcg

__all__ = ["KrylovInfo", "krylov_dispatch", "pcg"]
