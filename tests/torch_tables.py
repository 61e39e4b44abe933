"""Test helper: a pair map with some entries moved from their cuckoo rows
into the stash, so that the stash path of a lookup is exercised (the
native builder rarely stashes anything at test sizes)."""

import numpy as np

from mindthegap_tpu_torch.ops import extmap as X

_M64 = (1 << 64) - 1


def _mix(key: int, const: int) -> int:
    h = ((key ^ (key >> 33)) * const) & _M64
    return h ^ (h >> 29)


def move_to_stash(qp: X.QMapP, keys) -> X.QMapP:
    """Copy of host map `qp` with the rows of `keys` (canonical (k-2)-mers
    present in the table) cleared and their (L36, R36) put in the stash."""
    slots = qp.slots.copy()
    shift = 64 - qp.log_size
    stash = []
    for key in (int(x) for x in keys):
        for i, const in enumerate((int(X._H1), int(X._H2))):
            h = _mix(key, const)
            row = h >> shift
            lane0, lane1 = int(slots[row, 0]), int(slots[row, 1])
            if ((lane0 >> 9) & 1) and ((lane0 >> 8) & 1) == i and ((lane0 >> 10) & ((1 << 45) - 1)) == h & ((1 << shift) - 1):
                stash.append((key, ((lane0 & 0xFF) << 28) | (lane1 >> 36), lane1 & ((1 << 36) - 1)))
                slots[row] = 0
                break
        else:
            raise KeyError(f"{key} is not in the table")
    stash.sort()
    sk, sl, sr = (np.array(col, np.uint64) for col in zip(*stash))
    return X.QMapP(slots, qp.log_size, qp.k, sk, sl, sr)
