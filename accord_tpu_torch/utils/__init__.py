from accord_tpu_torch.utils.invariants import Invariants, IllegalState, IllegalArgument
from accord_tpu_torch.utils.rng import RandomSource
from accord_tpu_torch.utils.async_ import AsyncResult, AsyncChain, settable

__all__ = [
    "Invariants", "IllegalState", "IllegalArgument", "RandomSource",
    "AsyncResult", "AsyncChain", "settable",
]
