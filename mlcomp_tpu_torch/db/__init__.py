from mlcomp_tpu_torch.db.store import Store

__all__ = ["Store"]
