"""ctypes bridge to the native gap-fill traversal engine
(native/traversal.cpp) — a scalar C++ port of fill/traversal.py's
construct_linear_seqs / traverse_right over the fused cuckoo quotient map
(ops/extmap.py QMap), bit-exact with the python engine and ~1-2 orders of
magnitude faster (the fill hot loop #3, reference src/Filler.cpp:854-884).

The library is compiled on demand (mindthegap_tpu_torch/_build.py), same
pattern as utils/stdcompat.py. k <= 32 only (u64 node lanes) — callers fall
back to the python engine for larger spans or bucket-layout maps.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import native_library

_lib = None

# ABI order of TraversalPolicy knobs (native/traversal.cpp struct Policy)
_SKIP_MODES = {"skip": 0, "kmer": 1, "no": 2}
_SWF_MODES = {"none": 0, "r_in_seq": 1, "seq_in_r": 2, "anchor_in_seq": 3}

REASONS = ("tip", "fork", "merge", "marked", "maxlen")


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = native_library("traversal.cpp", "libmtgtraversal.so")
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.mtg_tsession_new.restype = ctypes.c_void_p
    lib.mtg_tsession_new.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.mtg_tsession_free.argtypes = [ctypes.c_void_p]
    lib.mtg_tsession_reset_marks.argtypes = [ctypes.c_void_p]
    lib.mtg_tsession_set_policy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mtg_traverse_right.restype = ctypes.c_int64
    lib.mtg_traverse_right.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, u64p, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mtg_construct_linear_seqs.restype = ctypes.c_int64
    lib.mtg_construct_linear_seqs.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    # span (k > 32) sessions
    lib.mtg_tsession_new_span.restype = ctypes.c_void_p
    lib.mtg_tsession_new_span.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.mtg_tsession_free_span.argtypes = [ctypes.c_void_p]
    lib.mtg_tsession_reset_marks_span.argtypes = [ctypes.c_void_p]
    lib.mtg_tsession_set_policy_span.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.mtg_traverse_right_span.restype = ctypes.c_int64
    lib.mtg_traverse_right_span.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mtg_construct_linear_seqs_span.restype = ctypes.c_int64
    lib.mtg_construct_linear_seqs_span.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def policy_array(policy) -> np.ndarray:
    """Serialize a TraversalPolicy into the native int32 knob array.
    Raises KeyError on unknown enum strings (caller falls back to python)."""
    return np.array(
        [
            int(policy.in_branch_stop),
            int(policy.explore_branching),
            int(policy.bubble_max_depth),
            int(policy.bubble_max_breadth),
            int(policy.consensus_identity),
            int(policy.start_mark),
            int(policy.passed_branch_mark),
            int(policy.branch_stop_mark),
            _SKIP_MODES[policy.skip_marked_start],
            int(policy.stop_at_marked),
            int(policy.explore_marked_fail),
            int(policy.merge_reverse_check),
            _SWF_MODES[policy.swf_mode],
            int(policy.swf_noextend),
            int(policy.push_on_marked_stop),
            int(policy.marked_start_push),
            int(policy.lifo),
            int(policy.depth_with_kmer),
            int(policy.max_nodes_strict),
        ],
        dtype=np.int32,
    )


class NativeTraversal:
    """One traversal session bound to a fused QMap (cuckoo layout, k <= 32).

    Holds references to the map arrays so the native pointers stay valid.
    The terminator mark set lives native-side; construct_linear_seqs resets
    it per job (matching the python engine's per-job Terminator)."""

    def __init__(self, qmap, k: int, policy):
        lib = _load()
        if lib is None:
            raise RuntimeError("native traversal library unavailable")
        self._lib = lib
        # keep alive + enforce dtypes/contiguity for the raw pointers
        self._slots = np.ascontiguousarray(qmap.slots, dtype=np.uint64)
        self._stash_k = np.ascontiguousarray(qmap.stash_keys, dtype=np.uint64)
        self._stash_v = np.ascontiguousarray(qmap.stash_payload, dtype=np.uint16)
        self._pol = policy_array(policy)
        self.k = k
        self._sess = lib.mtg_tsession_new(
            self._slots.ctypes.data_as(ctypes.c_void_p),
            int(qmap.log_size),
            self._stash_k.ctypes.data_as(ctypes.c_void_p),
            self._stash_v.ctypes.data_as(ctypes.c_void_p),
            int(self._stash_k.size), int(k),
            self._pol.ctypes.data_as(ctypes.c_void_p),
        )
        if not self._sess:
            raise RuntimeError("mtg_tsession_new failed")
        # contigs: <= max_nodes+1 of <= max_depth + bubble + k bases each
        self._buf = ctypes.create_string_buffer(1 << 21)

    def close(self):
        if getattr(self, "_sess", None):
            self._lib.mtg_tsession_free(self._sess)
            self._sess = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_policy(self, policy):
        self._pol = policy_array(policy)
        self._lib.mtg_tsession_set_policy(self._sess, self._pol.ctypes.data_as(ctypes.c_void_p))

    def reset_marks(self):
        self._lib.mtg_tsession_reset_marks(self._sess)

    def traverse_right(self, start: int, maxlen: int):
        """One right extension (shares the session's persistent mark set).
        Returns (sequence, end_node, stop_reason)."""
        end = ctypes.c_uint64()
        reason = ctypes.c_int32()
        n = self._lib.mtg_traverse_right(
            self._sess, ctypes.c_uint64(start), int(maxlen),
            self._buf, len(self._buf), ctypes.byref(end), ctypes.byref(reason),
        )
        if n < 0:
            self._buf = ctypes.create_string_buffer(2 * -n)
            return self.traverse_right(start, maxlen)
        return self._buf.raw[:n].decode("ascii"), int(end.value), REASONS[reason.value]

    def construct_linear_seqs(self, start: int, R: str, max_depth: int,
                              max_nodes: int, swf: bool) -> list[str]:
        """One full gap-fill job's ordered contig list (marks reset
        internally, per-job Terminator semantics)."""
        rb = R.encode("ascii")
        n = self._lib.mtg_construct_linear_seqs(
            self._sess, ctypes.c_uint64(start), rb, len(rb),
            int(max_depth), int(max_nodes), int(bool(swf)),
            self._buf, len(self._buf),
        )
        if n < 0:
            self._buf = ctypes.create_string_buffer(2 * -n)
            return self.construct_linear_seqs(start, R, max_depth, max_nodes, swf)
        if n == 0:
            return []
        return self._buf.raw[:n].decode("ascii").split("\n")[:-1]


class NativeTraversalSpan:
    """Span traversal session (32 < k <= 256): multi-word nodes against the
    sorted big-endian solid key blob (binary-search membership; the
    SpanGraph backend of native/traversal.cpp). Start k-mers are python
    ints, converted to the MSW-first word rows of ops/span.py."""

    def __init__(self, solid_keys, k: int, policy):
        from ..ops.span import Span

        lib = _load()
        if lib is None:
            raise RuntimeError("native traversal library unavailable")
        assert 32 < k <= 256
        self._lib = lib
        self.k = k
        self._span = Span(k)
        keys = np.ascontiguousarray(solid_keys)
        assert keys.dtype.kind == "V" and keys.dtype.itemsize == 8 * self._span.W
        self._keys = keys  # keep alive: big-endian rows, memcmp-sorted
        self._pol = policy_array(policy)
        self._sess = lib.mtg_tsession_new_span(
            self._keys.ctypes.data_as(ctypes.c_void_p),
            int(keys.size), int(k),
            self._pol.ctypes.data_as(ctypes.c_void_p),
        )
        if not self._sess:
            raise RuntimeError("mtg_tsession_new_span failed")
        self._buf = ctypes.create_string_buffer(1 << 21)

    def close(self):
        if getattr(self, "_sess", None):
            self._lib.mtg_tsession_free_span(self._sess)
            self._sess = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_policy(self, policy):
        self._pol = policy_array(policy)
        self._lib.mtg_tsession_set_policy_span(self._sess, self._pol.ctypes.data_as(ctypes.c_void_p))

    def reset_marks(self):
        self._lib.mtg_tsession_reset_marks_span(self._sess)

    def traverse_right(self, start: int, maxlen: int):
        row = np.ascontiguousarray(self._span.int_to_row(start))
        end = np.zeros(self._span.W, np.uint64)
        reason = ctypes.c_int32()
        n = self._lib.mtg_traverse_right_span(
            self._sess, row.ctypes.data_as(ctypes.c_void_p), int(maxlen),
            self._buf, len(self._buf),
            end.ctypes.data_as(ctypes.c_void_p), ctypes.byref(reason),
        )
        if n < 0:
            self._buf = ctypes.create_string_buffer(2 * -n)
            return self.traverse_right(start, maxlen)
        end_int = 0
        for w in end:
            end_int = (end_int << 64) | int(w)
        return self._buf.raw[:n].decode("ascii"), end_int, REASONS[reason.value]

    def construct_linear_seqs(self, start: int, R: str, max_depth: int,
                              max_nodes: int, swf: bool) -> list[str]:
        row = np.ascontiguousarray(self._span.int_to_row(start))
        rb = R.encode("ascii")
        n = self._lib.mtg_construct_linear_seqs_span(
            self._sess, row.ctypes.data_as(ctypes.c_void_p), rb, len(rb),
            int(max_depth), int(max_nodes), int(bool(swf)),
            self._buf, len(self._buf),
        )
        if n < 0:
            self._buf = ctypes.create_string_buffer(2 * -n)
            return self.construct_linear_seqs(start, R, max_depth, max_nodes, swf)
        if n == 0:
            return []
        return self._buf.raw[:n].decode("ascii").split("\n")[:-1]
