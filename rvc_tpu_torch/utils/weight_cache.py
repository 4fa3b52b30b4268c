"""``WeightCache``: weights a module derives from its parameters (packed,
folded, stacked), built at first use and kept until a parameter changes.

The stage-tail kernels' wrappers (``ops/resblock.py``), the decoders, and
both predictors' modules (``predictors/rmvpe.py``, ``predictors/crepe.py``)
keep theirs in one; each rebuild counts into the recorder
(``utils/profiling.py``) under the counter the cache was given.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import profiling


class WeightCache:
    """Packed weights of one module, built at first use and rebuilt when one
    of the tensors they were made from is replaced, modified in place, or
    moved (identity, ``_version``, storage, dtype, device). Each rebuild
    adds one to the recorder's counter ``counter``. The entry is one tuple,
    replaced whole, so a thread never reads one key's value under another's."""

    def __init__(self, counter: str = "weight_packs"):
        self.counter = counter
        self._entry = (None, None, None)  # key, value, the key's tensors
        self.builds = 0

    def __deepcopy__(self, memo) -> "WeightCache":
        # a copied module's tensors are new ones: it builds its own
        return WeightCache(self.counter)

    def get(self, tensors: Sequence[torch.Tensor], extra, build: Callable):
        key = (extra, [(id(t), t._version, t.data_ptr(), t.dtype, t.device, t.shape)
                       for t in tensors])
        entry = self._entry
        if key != entry[0]:
            # the key's tensors are kept detached: their storage stays alive
            # (no other tensor takes its address while the key holds it)
            # but no autograd graph does
            entry = (key, build(), [t.detach() for t in tensors])
            self._entry = entry
            self.builds += 1
            profiling.count(self.counter)
        return entry[1]
