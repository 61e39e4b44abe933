"""Test helper: a fused map with some entries moved from their table slots
into the stash, so that the stash path of a lookup is exercised (the
native builders rarely stash anything at test sizes)."""

import numpy as np

from mindthegap_tpu_torch.ops import extmap as X

_M64 = (1 << 64) - 1
_EMPTY = 0xFFFFFFFFFFFFFFFF


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


def move_to_stash_walk(qm, keys):
    """Copy of host map `qm` (QMap or QMapB) with the slots of `keys`
    (canonical (k-1)-mers present in the table) cleared and their payloads
    added to the stash it already has."""
    bucket = isinstance(qm, X.QMapB)
    slots = qm.slots.copy()
    log = qm.log_nb if bucket else qm.log_size
    shift = 64 - log
    rem_mask = (1 << shift) - 1
    stash = [(int(k), int(v)) for k, v in zip(qm.stash_keys, qm.stash_payload) if int(k) != _EMPTY]
    for key in (int(x) for x in keys):
        if bucket:
            h = _mix(key, int(X._H1))
            cands = [((h >> shift) * 16 + s, 10, 1 << 9, None) for s in range(16)]
        else:
            cands = [(_mix(key, c) >> shift, 11, 1 << 10, i) for i, c in enumerate((int(X._H1), int(X._H2)))]
        for slot, rem_shift, valid, choice in cands:
            h = _mix(key, int(X._H1) if choice in (None, 0) else int(X._H2))
            v = int(slots[slot])
            if (v & valid) and (v >> rem_shift) == h & rem_mask and (choice is None or ((v >> 9) & 1) == choice):
                stash.append((key, v & 0x1FF))
                slots[slot] = 0
                break
        else:
            raise KeyError(f"{key} is not in the table")
    assert len(stash) <= 64
    stash.sort()
    sk = np.array([k for k, _ in stash], np.uint64)
    sv = np.array([v for _, v in stash], np.uint16)
    return (X.QMapB if bucket else X.QMap)(slots, log, sk, sv)
