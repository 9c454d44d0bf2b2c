"""Image codec and the prefetching pair loader (counterpart of
``nct_tpu.data``'s loader)."""

from nct_tpu_torch.data.loader import PairLoader

__all__ = ["PairLoader"]
