"""Needleman-Wunsch identity utility (reference src/nwAlign/nwalign.cpp).

Usage: python -m mindthegap_tpu_torch.nwalign [--device] < infile — two
lines, one sequence each; prints the identity. The default engine is the
native C++ rolling DP; --device runs the CUDA wavefront kernel
(ops/nw_device.py) on the GPU and raises when there is none.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None, stdin=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    stdin = sys.stdin if stdin is None else stdin
    device = "--device" in argv
    lines = []
    for line in stdin:
        lines.append(line.rstrip("\n"))
        if len(lines) > 2:
            print("Only two lines expected")
            break
    seq1 = lines[0] if len(lines) > 0 else ""
    seq2 = lines[1] if len(lines) > 1 else ""
    if device and seq1 and seq2:
        from .ops.nw_device import nw_identity_device

        print(float(nw_identity_device([(seq1, seq2)])[0]))
    else:
        from .ops.nw import nw_identity

        print(nw_identity(seq1, seq2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
